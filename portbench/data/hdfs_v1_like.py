"""An HDFS log in the format of Loghub's HDFS_v1 (Xu et al., SOSP 2009: a
Hadoop cluster of 203 nodes, 11,175,629 lines for 575,061 blocks, 1.47 GB),
made from a seed.

Each line is ``YYMMDD HHMMSS <thread> <LEVEL> <component>: <message>``. The
messages follow the log's event templates, and each block lives as a block
of HDFS_v1 does: the NameNode allocates it for a job's output file, three
DataNodes receive it in a pipeline (``Receiving block``, ``PacketResponder
... terminating``, ``Received block ... of size``), the NameNode records
each replica (``addStoredBlock``), and later readers, scanners and the
job's clean-up serve, verify, replicate and delete it. That makes 19.4
lines a block on average, as in HDFS_v1. Blocks start as a Poisson stream
and their events interleave in time order, as the cluster's merged log does.
The shares of the rarer events, the cluster's addresses, thread numbers and
timings are assumed."""

from __future__ import annotations

import datetime

import numpy as np

NODES = 203
BLOCK_BYTES = 67108864
START = datetime.datetime(2008, 11, 9, 20, 35, 18)
BLOCKS_PER_S = 4.1  # 575,061 blocks in HDFS_v1's 38.7 hours
MEAN_LINE = 131     # bytes a line: 1.47e9 / 11,175,629

# (event, probability for a block, replicas): the rarer events' shares
# are assumed; the pipeline's four events are three lines each.
LATER = (("served", 0.55, 2), ("served_fail", 0.12, 1), ("verified", 0.20, 1),
         ("transfer", 0.05, 1), ("delete", 0.72, 3))


def _nodes(r):
    a = r.integers(0, 2, NODES)
    b = r.integers(0, 256, NODES)
    c = r.integers(1, 255, NODES)
    return [f"10.{250 + x}.{y}.{z}" for x, y, z in zip(a, b, c)]


def generate(size: int, seed: int) -> bytes:
    r = np.random.default_rng(seed % 2**64)
    nodes = _nodes(np.random.default_rng(1898))
    nblocks = int(size / (19.4 * MEAN_LINE) * 1.25) + 16
    start = np.cumsum(r.exponential(1.0 / BLOCKS_PER_S, nblocks))
    ids = r.integers(-2**63, 2**63 - 1, nblocks, dtype=np.int64)
    task = r.integers(0, 2000, nblocks)
    job = 1 + (start // 3600).astype(np.int64)
    pipe = np.stack([r.choice(NODES, 3, replace=False) for _ in range(nblocks)])
    write_s = r.uniform(2.0, 90.0, nblocks)
    sizes = np.where(r.random(nblocks) < 0.9, BLOCK_BYTES, r.integers(1 << 16, BLOCK_BYTES, nblocks))

    # Every line is (time, block, event, replica, peer, thread); the text is
    # made after sorting by time.
    t, blk, ev, rep = [], [], [], []

    def add(times, which, name, replica):
        t.append(times)
        blk.append(which)
        ev.append(np.full(len(which), EVENTS.index(name)))
        rep.append(np.full(len(which), replica))

    every = np.arange(nblocks)
    add(start, every, "allocate", 0)
    for i in range(3):
        add(start + 0.05 * i + r.uniform(0, 0.5, nblocks), every, "receiving", i)
        done = start + write_s + r.uniform(0, 1.5, nblocks)
        add(done, every, "responder", i)
        add(done + r.uniform(0, 0.2, nblocks), every, "received", i)
        add(done + r.uniform(0, 0.4, nblocks), every, "stored", i)
    for name, share, reps in LATER:
        hit = every[r.random(nblocks) < share]
        base = start[hit] + write_s[hit] + r.exponential(1800.0, len(hit))
        for i in range(reps):
            when = base + r.uniform(0, 30.0, len(hit))
            add(when, hit, name, i)
            if name == "delete":
                add(when + r.uniform(1.0, 20.0, len(hit)), hit, "deleting", i)
    t = np.concatenate(t)
    blk = np.concatenate(blk)
    ev = np.concatenate(ev)
    rep = np.concatenate(rep)
    order = np.argsort(t, kind="stable")
    peers = r.integers(0, NODES, len(t))
    threads = r.integers(1, 4000, len(t))
    nn_threads = r.integers(19, 36, len(t))
    ports = r.integers(32768, 61000, len(t))

    out: list[str] = []
    total = 0
    stamp_s, stamp = -1, ""
    for k in order:
        s = int(t[k])
        if s != stamp_s:
            stamp_s, stamp = s, (START + datetime.timedelta(seconds=s)).strftime("%y%m%d %H%M%S")
        b = blk[k]
        name = EVENTS[ev[k]]
        node = nodes[pipe[b, rep[k] % 3]]
        peer = nodes[peers[k]]
        block = f"blk_{ids[b]}"
        if name == "allocate":
            line = (f"{nn_threads[k]} INFO dfs.FSNamesystem: BLOCK* NameSystem.allocateBlock: "
                    f"/user/root/rand/_temporary/_task_200811092030_{job[b]:04d}_m_{task[b]:06d}_0/"
                    f"part-{task[b]:05d}. {block}")
        elif name == "receiving":
            src = nodes[pipe[b, rep[k] - 1]] if rep[k] else peer
            line = (f"{threads[k]} INFO dfs.DataNode$DataXceiver: Receiving block {block} "
                    f"src: /{src}:{ports[k]} dest: /{node}:50010")
        elif name == "responder":
            line = (f"{threads[k]} INFO dfs.DataNode$PacketResponder: PacketResponder {2 - rep[k]} "
                    f"for block {block} terminating")
        elif name == "received":
            line = (f"{threads[k]} INFO dfs.DataNode$PacketResponder: Received block {block} "
                    f"of size {sizes[b]} from /{node}")
        elif name == "stored":
            line = (f"{nn_threads[k]} INFO dfs.FSNamesystem: BLOCK* NameSystem.addStoredBlock: "
                    f"blockMap updated: {node}:50010 is added to {block} size {sizes[b]}")
        elif name == "served":
            line = f"{threads[k]} INFO dfs.DataNode: {node}:50010 Served block {block} to /{peer}"
        elif name == "served_fail":
            line = (f"{threads[k]} WARN dfs.DataNode: {node}:50010:Got exception while serving "
                    f"{block} to /{peer}:")
        elif name == "verified":
            line = f"{threads[k]} INFO dfs.DataBlockScanner: Verification succeeded for {block}"
        elif name == "transfer":
            line = (f"{threads[k]} INFO dfs.DataNode: {node}:50010 Starting thread to transfer "
                    f"block {block} to {peer}:50010")
        elif name == "delete":
            line = (f"{nn_threads[k]} INFO dfs.FSNamesystem: BLOCK* NameSystem.delete: {block} "
                    f"is added to invalidSet of {node}:50010")
        else:
            line = (f"{threads[k]} INFO dfs.FSDataset: Deleting block {block} file "
                    f"/mnt/hadoop/dfs/data/current/subdir{ids[b] % 64}/{block}")
        text = f"{stamp} {line}\n"
        out.append(text)
        total += len(text)
        if total >= size:
            break
    if total < size:
        raise ValueError("too few blocks drawn for the size asked")
    return "".join(out).encode()[:size]


EVENTS = ("allocate", "receiving", "responder", "received", "stored", "served",
          "served_fail", "verified", "transfer", "delete", "deleting")


if __name__ == "__main__":
    import zstandard

    data = generate(64 * 2**20, 7)
    lines = data.count(b"\n")
    print(f"{lines} lines, {len(data) / lines:.1f} bytes a line")
    print(data[:600].decode())
    for level in (1, 3):
        c = zstandard.ZstdCompressor(level=level)
        stored = sum(len(c.compress(data[i:i + 2**21])) for i in range(0, len(data), 2**21))
        print(f"level {level}: {100 * stored / len(data):.2f}%")
