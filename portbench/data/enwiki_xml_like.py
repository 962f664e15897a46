"""English Wikipedia's ``pages-articles`` dump from a seed: MediaWiki export
XML (format 0.11), a ``<siteinfo>`` head and then one ``<page>`` after
another, each with its title, namespace, id, latest revision (ids,
timestamp, contributor, comment, model, format, the wikitext in ``<text>``
with its ``bytes`` and ``sha1``) as https://meta.wikimedia.org/wiki/Data_dumps
describes it. The wikitext is XML-escaped as in the dump: ``[[links]]``,
``{{templates}}``, ``'''bold'''``, ``== headings ==``, ``&lt;ref&gt;``
citations; a redirect page holds ``#REDIRECT [[...]]`` and its category
templates.

``layout(size)`` gives every page's offset and length in bytes. It is drawn
from the module's own seed, never from the run's, so every seed lays out
the same pages; ``generate(size, seed)`` fills each page to exactly its
length with text drawn from ``seed``. The page lengths (assumed, the dump's
shares are not in the repository): a share ``REDIRECT_SHARE`` of redirect
stubs of 800-1200 bytes (the export's markup of a page alone is
~0.7 KiB), and articles lognormal about ``ARTICLE_MEDIAN``
bytes, at least ``ARTICLE_MIN`` and at most 1 MiB; the mean page is about
4.6 KiB, as the dump's ~95-100 GB of XML over its ~22 million pages gives.

``WORD_ZIPF`` was chosen so that libzstd at level 3 stores about a third of
the XML in 512 KiB frames (``python3 -m portbench.data.enwiki_xml_like``
prints the share)."""

from __future__ import annotations

import hashlib

import numpy as np

LAYOUT_SEED = 20010115  # the day Wikipedia went online
CHUNK = 4096            # pages drawn at a time, so a larger size keeps the smaller's pages
REDIRECT_SHARE = 0.45
REDIRECT_MIN, REDIRECT_MAX = 800, 1200
ARTICLE_MEDIAN, ARTICLE_SIGMA = 4500.0, 1.05
ARTICLE_MIN, PAGE_MAX = 1400, 1 << 20
WORD_ZIPF = 1.2
VOCAB_SEED, VOCAB_WORDS = 1898, 20000
LETTERS = "etaoinshrdlcumwfgypbvkjxqz"
LETTER_PCT = (12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
              2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07)

HEAD = (
    '<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.11/" '
    'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
    'xsi:schemaLocation="http://www.mediawiki.org/xml/export-0.11/ '
    'http://www.mediawiki.org/xml/export-0.11.xsd" version="0.11" xml:lang="en">\n'
    "  <siteinfo>\n"
    "    <sitename>Wikipedia</sitename>\n"
    "    <dbname>enwiki</dbname>\n"
    "    <base>https://en.wikipedia.org/wiki/Main_Page</base>\n"
    "    <generator>MediaWiki 1.43.0-wmf.1</generator>\n"
    "    <case>first-letter</case>\n"
    "    <namespaces>\n"
    + "".join(f'      <namespace key="{k}" case="first-letter">{n}</namespace>\n'
              for k, n in ((-2, "Media"), (-1, "Special"), (1, "Talk"), (2, "User"),
                           (3, "User talk"), (4, "Wikipedia"), (5, "Wikipedia talk"),
                           (6, "File"), (7, "File talk"), (8, "MediaWiki"),
                           (9, "MediaWiki talk"), (10, "Template"), (11, "Template talk"),
                           (12, "Help"), (13, "Help talk"), (14, "Category"),
                           (15, "Category talk"), (100, "Portal"), (101, "Portal talk"),
                           (118, "Draft"), (119, "Draft talk"), (710, "TimedText"),
                           (711, "TimedText talk"), (828, "Module"), (829, "Module talk")))
    + '      <namespace key="0" case="first-letter" />\n'
    "    </namespaces>\n"
    "  </siteinfo>\n"
).encode()
FOOT = b"</mediawiki>\n"

COMMENTS = ("", "/* History */ ce", "/* Early life */ copyedit", "Added {{short description}}",
            "[[WP:AWB|AWB]] cleanup", "Reverted edits ([[WP:HG|HG]])", "Fixed typo",
            "rm unsourced claim", "Updated population figures", "/* References */ fix cite",
            "Bot: Fixing [[WP:LINT|lint]] errors", "[[WP:RCAT|Rcat]] shell")
RCATS = ("{{R from move}}", "{{R from alternative name}}", "{{R from other capitalisation}}",
         "{{R from misspelling}}", "{{R unprintworthy}}", "{{R from short name}}",
         "{{R from plural}}", "{{R to section}}", "{{R from ambiguous term}}",
         "{{R from abbreviation}}", "{{R from former name}}", "{{R printworthy}}")
MONTHS = ("January", "February", "March", "April", "May", "June", "July", "August",
          "September", "October", "November", "December")
ENTITIES = ((b"&lt;", 3), (b"&gt;", 3), (b"&quot;", 5), (b"&amp;", 4))


def _pages(size: int):
    """(lengths, redirect) of every page in ``size`` bytes of XML."""
    body = size - len(HEAD) - len(FOOT)
    if body < ARTICLE_MIN:
        raise ValueError(f"{size} bytes hold no page")
    r = np.random.default_rng(LAYOUT_SEED)
    lens, reds, total = [], [], 0
    while total < body:
        red = r.random(CHUNK) < REDIRECT_SHARE
        short = r.integers(REDIRECT_MIN, REDIRECT_MAX + 1, CHUNK)
        long = np.exp(r.normal(np.log(ARTICLE_MEDIAN), ARTICLE_SIGMA, CHUNK))
        n = np.where(red, short, np.clip(long, ARTICLE_MIN, PAGE_MAX).astype(np.int64))
        lens.append(n)
        reds.append(red)
        total += int(n.sum())
    lens, reds = np.concatenate(lens), np.concatenate(reds)
    end = np.cumsum(lens)
    k = int(np.searchsorted(end, body)) + 1
    lens, reds = lens[:k].copy(), reds[:k].copy()
    lens[-1] -= int(end[k - 1]) - body
    # The last page is cut to fit; one cut below its kind's least joins the one before.
    if k > 1 and lens[-1] < (REDIRECT_MIN if reds[-1] else ARTICLE_MIN):
        lens[-2] += lens[-1]
        lens, reds = lens[:-1], reds[:-1]
    return lens, reds


def layout(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, lengths) of every page, the same for every seed."""
    lens, _red = _pages(size)
    offs = len(HEAD) + np.concatenate([[0], np.cumsum(lens)[:-1]])
    return offs.astype(np.int64), lens.astype(np.int64)


def vocabulary() -> list[str]:
    """A fixed word list, most frequent first: 2-16 letters spelt from
    English letter frequencies, the short words leading (as
    ``dickens_like``'s, but drawn in one pass: its word-by-word draw takes
    about 0.8 s of the 5 s this generator may take for 64 MiB)."""
    r = np.random.default_rng(VOCAB_SEED)
    lengths = np.clip(r.poisson(5.0, VOCAB_WORDS) + 2, 2, 16)
    p = np.array(LETTER_PCT) / sum(LETTER_PCT)
    letters = np.array(list(LETTERS))[r.choice(26, int(lengths.sum()), p=p)]
    cuts = np.cumsum(lengths)[:-1]
    words = list(dict.fromkeys("".join(w) for w in np.split(letters, cuts)))
    order = np.argsort(np.array([len(w) for w in words]) + 3.0 * r.random(len(words)),
                       kind="stable")
    return [words[i] for i in order]


def _clean_end(b: bytes) -> bytes:
    """``b`` with an entity cut at its end blanked, so the XML stays well formed."""
    amp = b.rfind(b"&", max(len(b) - 6, 0))
    if amp >= 0 and b.find(b";", amp) < 0:
        b = b[:amp] + b" " * (len(b) - amp)
    return b


def _unescaped(b: bytes) -> int:
    return len(b) - sum(b.count(e) * extra for e, extra in ENTITIES)


def _base36(digest: bytes) -> str:
    n, out = int.from_bytes(digest, "big"), []
    while n:
        n, d = divmod(n, 36)
        out.append("0123456789abcdefghijklmnopqrstuvwxyz"[d])
    return "".join(reversed(out)).rjust(31, "0")


class _Body:
    """Article prose, drawn in bulk from the seed and handed out in order:
    words by Zipf's law, some linked, italic or bold, sentences closed with
    citations, paragraphs, headings, list items and inline templates."""

    VARIANTS = ("{} ", "[[{}]] ", "''{}'' ", "'''{}''' ", "{}, ", "{}. ")
    VARIANT_P = (0.70, 0.11, 0.02, 0.01, 0.07, 0.09)

    def __init__(self, r, words):
        self.r = r
        ranks = np.arange(1, len(words) + 1, dtype=np.float64)
        self.cdf = np.cumsum(ranks ** -WORD_ZIPF)
        self.cdf /= self.cdf[-1]
        pieces = [v.format(w) for w in words for v in self.VARIANTS]
        cap = [w.capitalize() for w in words]
        pick = lambda n: r.integers(0, len(words), n)  # noqa: E731
        refs = []
        for a, b, c, y, m, d in zip(pick(3000), pick(3000), pick(3000), r.integers(1990, 2025, 3000),
                                    r.integers(0, 12, 3000), r.integers(1, 29, 3000)):
            if d % 4 == 0:
                refs.append(f"&lt;ref name=&quot;{words[a]}{y}&quot; /&gt; ")
            else:
                refs.append(f"&lt;ref&gt;{{{{cite web |url=https://www.{words[a]}.com/{words[b]}/"
                            f"{words[c]} |title={cap[b]} {words[c]} |website={cap[a]} "
                            f"|date={d} {MONTHS[m]} {y} |access-date={d} {MONTHS[m - 1]} "
                            f"{y + 1}}}}}&lt;/ref&gt; ")
        heads = [f"\n\n== {cap[a]} ==\n" if a % 3 else f"\n\n=== {cap[a]} {words[b]} ===\n"
                 for a, b in zip(pick(400), pick(400))]
        temps = [f"{{{{convert|{n}|km|mi}}}} " if n % 2 else f"{{{{lang|fr|{words[a]}}}}} "
                 for a, n in zip(pick(400), r.integers(1, 5000, 400))]
        self.specials = [len(pieces), len(refs), 1, len(heads), 1, len(temps)]
        pieces += refs + ["\n\n"] + heads + ["\n* "] + temps
        self.pieces = np.array([p.encode() for p in pieces], dtype=object)
        self.buf, self.pos = b"", 0

    def _more(self, n: int) -> bytes:
        """About ``n`` bytes of prose: a token's word and variant, and after
        each sentence a citation (25%), a paragraph (10%), a heading (3%), a
        list item (3%) or a template (4%)."""
        r = self.r
        count = max(n // 7, 1024)
        words = np.searchsorted(self.cdf, r.random(count))
        variant = np.searchsorted(np.cumsum(self.VARIANT_P), r.random(count) * 0.999999)
        ids = words * len(self.VARIANTS) + variant
        u = r.random(count)
        base, n_refs, _p, n_heads, _l, n_temps = self.specials
        kinds = np.searchsorted([0.25, 0.35, 0.38, 0.41, 0.45], u)
        first = np.cumsum([base, n_refs, 1, n_heads, 1])
        size = np.array([n_refs, 1, n_heads, 1, n_temps, 1])
        extra = first[np.minimum(kinds, 4)] + (r.random(count) * size[kinds]).astype(np.int64)
        extra[(variant != 5) | (kinds == 5)] = -1
        ids = np.stack([ids, extra], 1).ravel()
        return b"".join(self.pieces[ids[ids >= 0]].tolist())

    def take(self, n: int) -> bytes:
        """The next ``n`` bytes of prose."""
        while self.pos + n > len(self.buf):
            self.buf = self.buf[self.pos:] + self._more(max(n, 1 << 22))
            self.pos = 0
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def generate(size: int, seed: int) -> bytes:
    lens, reds = _pages(size)
    n = len(lens)
    words = vocabulary()
    r = np.random.default_rng(seed % 2**64)
    body = _Body(r, words)
    cap = [w.capitalize() for w in words]
    title_words = r.integers(0, len(words), (n, 4))
    title_len = r.integers(1, 5, n)
    page_ids = np.cumsum(r.integers(1, 4000, n)) + 1000
    rev_ids = r.integers(900_000_000, 1_250_000_000, n)
    parent_gap = r.integers(1, 5_000_000, n)
    stamps = np.datetime_as_string(
        np.datetime64("2024-06-01T00:00:00") - r.integers(0, 20 * 365 * 86400, n).astype("m8[s]"),
        unit="s")
    users = r.integers(0, len(words), n)
    user_ids = r.integers(1, 48_000_000, n)
    anon = r.random(n) < 0.15
    ips = r.integers(1, 255, (n, 4))
    comments = r.integers(0, len(COMMENTS), n)
    targets = r.integers(0, len(words), (n, 2))
    rcats = r.integers(0, len(RCATS), (n, 4))
    facts = r.integers(0, len(words), (n, 6))
    years = r.integers(1850, 2020, n)

    out = [HEAD]
    for i in range(n):
        title = " ".join(cap[w] if k == 0 else words[w]
                         for k, w in enumerate(title_words[i, :title_len[i]]))
        if anon[i]:
            who = f"        <ip>{'.'.join(str(x) for x in ips[i])}</ip>\n"
        else:
            who = (f"        <username>{cap[users[i]]}{user_ids[i] % 1000}</username>\n"
                   f"        <id>{user_ids[i]}</id>\n")
        comment = COMMENTS[comments[i]]
        t = facts[i]
        if reds[i]:
            target = f"{cap[targets[i, 0]]} {words[targets[i, 1]]}"
            redirect = f'    <redirect title="{target}" />\n'
            lead = (f"#REDIRECT [[{target}]]\n\n{{{{Redirect category shell|\n"
                    + "".join(RCATS[k] + "\n" for k in rcats[i]) + "}}").encode()
            tail = b""
        else:
            redirect = ""
            lead = (f"{{{{Short description|{cap[t[0]]} {words[t[1]]} {words[t[2]]}}}}}\n"
                    f"{{{{Use dmy dates|date={MONTHS[years[i] % 12]} 2023}}}}\n"
                    f"{{{{Infobox {words[t[3]]}\n| name = {title}\n| image = {cap[t[4]]}.jpg\n"
                    f"| established = {years[i]}\n}}}}\n'''{title}''' is a {words[t[5]]} ").encode()
            tail = (f"\n\n== References ==\n{{{{Reflist}}}}\n\n== External links ==\n"
                    f"* [https://www.{words[t[0]]}.org Official website]\n\n"
                    f"[[Category:{cap[t[1]]} {words[t[2]]}]]\n"
                    f"[[Category:{years[i]} establishments]]").encode()
        head = (f"  <page>\n    <title>{title}</title>\n    <ns>0</ns>\n    <id>{page_ids[i]}</id>\n"
                f"{redirect}    <revision>\n      <id>{rev_ids[i]}</id>\n"
                f"      <parentid>{rev_ids[i] - parent_gap[i]}</parentid>\n"
                f"      <timestamp>{stamps[i]}Z</timestamp>\n      <contributor>\n{who}"
                f"      </contributor>\n")
        page = _page(head, comment, rev_ids[i], lead, tail, body, int(lens[i]))
        out.append(page)
    out.append(FOOT)
    data = b"".join(out)
    if len(data) != size:
        raise AssertionError(f"made {len(data)} bytes for {size}")
    return data


def _page(head: str, comment: str, rev_id: int, lead: bytes, tail: bytes, body: _Body,
          length: int) -> bytes:
    """One ``<page>`` of exactly ``length`` bytes: the wikitext is cut or
    filled with prose so that the page, with the text's byte count (of the
    unescaped text, as the dump counts it) and SHA-1, comes to ``length``.
    Where no count's width fits, the comment takes one more space."""
    for pad in (0, 1):
        said = comment + " " * pad
        com = f"      <comment>{said}</comment>\n" if said else ""
        pre = (f"{head}{com}      <origin>{rev_id}</origin>\n      <model>wikitext</model>\n"
               f"      <format>text/x-wiki</format>\n      <text bytes=\"").encode()
        mid = b'" sha1="' + b"x" * 31 + b'" xml:space="preserve">'
        post = b"</text>\n      <sha1>" + b"x" * 31 + b"</sha1>\n    </revision>\n  </page>\n"
        fixed = len(pre) + len(mid) + len(post)
        for digits in range(len(str(length)), 0, -1):
            n = length - fixed - digits
            if n < 0:
                continue
            text = _text(lead, tail, body, n)
            count = _unescaped(text)
            if len(str(count)) != digits:
                body.pos -= max(n - len(lead) - len(tail), 0)  # hand the prose back
                continue
            sha = _base36(hashlib.sha1(text).digest()).encode()
            return (pre + str(count).encode() + mid.replace(b"x" * 31, sha) + text
                    + post.replace(b"x" * 31, sha))
    raise ValueError(f"no page of {length} bytes fits its header")


def _text(lead: bytes, tail: bytes, body: _Body, n: int) -> bytes:
    """``n`` bytes of wikitext: the lead, prose, the tail; cut where short."""
    fill = n - len(lead) - len(tail)
    if fill < 0:
        return _clean_end((lead + tail)[:n])
    return lead + _clean_end(body.take(fill)) + tail


if __name__ == "__main__":
    import time

    import zstandard

    t0 = time.perf_counter()
    data = generate(64 * 2**20, 7)
    print(f"64 MiB in {time.perf_counter() - t0:.2f} s")
    offs, lens = layout(len(data))
    print(f"{len(lens)} pages, mean {lens.mean():.0f} bytes, largest {lens.max()}")
    print(data[offs[1]:offs[1] + 1500].decode())
    c = zstandard.ZstdCompressor(level=3)
    frame = 1 << 19
    stored = sum(len(c.compress(data[i:i + frame])) for i in range(0, len(data), frame))
    print(f"level 3, 512 KiB frames: {100 * stored / len(data):.2f}%")
