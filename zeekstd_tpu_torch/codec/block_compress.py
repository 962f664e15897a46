"""Per-block compression: match finding, literals section (raw/RLE/Huffman),
sequences section, and the raw-block fallback."""

from __future__ import annotations

from . import frame as frame_mod
from . import huffman
from .literals import (
    LIT_COMPRESSED,
    LIT_RAW,
    LIT_RLE,
    LIT_TREELESS,
    write_literals_header,
)
from .match import MatchState, find_sequences
from .seq_encode import encode_sequences_section


def encode_literals_section(literals: bytes, state=None) -> bytes:
    """Serialize the literals section, choosing the cheapest representation.

    When ``state`` carries the previous block's Huffman table and reusing it
    beats describing a fresh tree, Treeless_Literals are emitted
    (RFC 8878 §3.1.1.3.1.1 type 3; decoder mirror: literals.py).
    """
    n = len(literals)
    if n == 0:
        return write_literals_header(LIT_RAW, 0, 0, False)
    first = literals[0]
    if literals.count(first) == n:
        return write_literals_header(LIT_RLE, n, 0, False) + bytes([first])

    raw = write_literals_header(LIT_RAW, n, 0, False) + literals
    if n < 32:
        return raw  # too small for entropy coding to pay off

    freqs = {}
    for b in literals:
        freqs[b] = freqs.get(b, 0) + 1
    if len(freqs) < 2:
        return raw
    lengths = huffman.package_merge_lengths(freqs)
    weights = huffman.lengths_to_weights(lengths, max(freqs))
    try:
        tree = huffman.write_weights(weights)
        codes, nb, _ = huffman.build_encode_table(weights)
    except Exception:
        return raw

    # Treeless: reuse the previous block's table when it covers all present
    # symbols and costs less than a fresh tree description.
    prev = getattr(state, "huf_table", None) if state is not None else None
    use_prev = False
    if prev is not None:
        p_codes, p_nb = prev
        if all(s < len(p_nb) and p_nb[s] > 0 for s in freqs):
            new_bits = sum(c * int(nb[s]) for s, c in freqs.items()) + 8 * len(tree)
            prev_bits = sum(c * int(p_nb[s]) for s, c in freqs.items())
            if prev_bits <= new_bits:
                use_prev = True
                codes, nb = p_codes, p_nb
                tree = b""

    if n < 256:
        stream = huffman.compress_literals_1stream(literals, codes, nb)
        four = False
    else:
        stream = huffman.compress_literals_4stream(literals, codes, nb)
        four = True
        if stream is None:
            return raw
    payload = tree + stream
    lit_type = LIT_TREELESS if use_prev else LIT_COMPRESSED
    try:
        header = write_literals_header(lit_type, n, len(payload), four)
    except Exception:
        return raw
    if len(header) + len(payload) >= len(raw):
        return raw
    if state is not None and not use_prev:
        state.huf_table = (codes, nb)
    return header + payload


def compress_block(state, pos: int, size: int, last: bool) -> bytes:
    """Compress ``size`` bytes at frame offset ``pos``; returns block header +
    body. Falls back to raw/RLE blocks when entropy coding does not pay."""
    wstart = state.prefix_len + pos
    wend = wstart + size
    data = bytes(state.window[wstart:wend])

    if size > 0 and data.count(data[0]) == size:
        return frame_mod.write_block_header(last, frame_mod.BLOCK_RLE, size) + data[:1]

    if state.match_state is None:
        state.match_state = MatchState(len(state.window))
        if state.prefix_len:
            # Index the referenced prefix so matches can reach into it
            # (the ref_prefix contract; reference: lib/src/encode.rs:332-338).
            from .match import bulk_insert

            bulk_insert(
                state.match_state,
                state.window,
                0,
                state.prefix_len,
                state.params.hash_bytes,
            )
            if state.ldm_state is not None:
                from .match import ldm_bulk_insert

                ldm_bulk_insert(state.ldm_state, state.window, 0, state.prefix_len)
    if state.ldm_state is not None:
        # In-window positions of this block are probe-safe immediately
        # (candidates must satisfy c < p), so one vectorized insert covers
        # the block.
        from .match import ldm_bulk_insert

        ldm_bulk_insert(state.ldm_state, state.window, wstart, wend)

    seqs, literals, new_reps = find_sequences(
        state.window,
        wstart,
        wend,
        state.params,
        state.match_state,
        state.rep_offsets,
        max_dist=state.max_offset,
        ldm=state.ldm_state,
    )
    # Snapshot carried entropy state: a raw fallback must leave the
    # decoder-visible repeat/treeless/repeat-table state untouched.
    huf_before = state.huf_table
    tables_before = dict(state.seq_tables)
    body = encode_literals_section(literals, state) + encode_sequences_section(
        seqs, state.seq_tables
    )

    if len(body) >= size:
        state.huf_table = huf_before
        state.seq_tables = tables_before
        return frame_mod.write_block_header(last, frame_mod.BLOCK_RAW, size) + data

    state.rep_offsets = new_reps
    return frame_mod.write_block_header(last, frame_mod.BLOCK_COMPRESSED, len(body)) + body
