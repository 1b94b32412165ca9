"""Sidecar file formats: .rle / .freq / .cod / .shaf — the compatibility ABI.

Copy of shafa_tpu/formats.py:1-368.

These formats are the byte-exact contract between pipeline stages (and with the
C reference). Grammar, verified against the reference [SURVEY.md §2.1]:

  .freq  (writer f.c:287-294,312-329; readers t.c:278-332, d.c:268-281)
      "@R@<n>" | "@N@<n>"   header: mode + number of blocks, decimal ASCII
      per block: "@<stream_size>@<f0>( ';'* | ';' f1 ...)"  with consecutive
      equal frequencies elided: after printing freq[i], one ';' is emitted per
      symbol in the equal-run (including the first), except no ';' is printed
      for symbol index 255 (write_freq f.c:94-110).
      trailer "@0" after the last block (f.c:112-116).

  .cod   (writer t.c:302,350-362,396; readers c.c:115-177, d.c:466-504)
      "@R@<n>" | "@N@<n>"   header: mode copied from .freq (t.c:302)
      per block: "@<decoded_size>@<code0>;<code1>;...;<code255>"
      each code a string over {'0','1'}, empty for absent symbols, in symbol
      order; trailer "@0" (t.c:395-396).

  .shaf  (writer c.c:351,256-258; reader d.c:673,697-706)
      "@<n>" header (no mode char); per block "@<packed_size>@<raw bytes>";
      NO trailer. Raw bytes may contain '@' — parse by length, not delimiter.

  .rle   raw escape-coded byte stream (f.c:29-55); no framing of its own
      (block sizes come from the .freq sidecar, README.md:13).

Extension algebra (reference: src/modules/utils/extensions.{c,h}).
"""

from __future__ import annotations

import dataclasses
import re
from typing import IO, Iterator, Sequence

from .errors import FileUnrecognizableError

RLE_EXT = ".rle"
FREQ_EXT = ".freq"
CODES_EXT = ".cod"
SHAFA_EXT = ".shaf"

NUM_SYMBOLS = 256


# ---------------------------------------------------------------------------
# Extension algebra (extensions.c:17-65)
# ---------------------------------------------------------------------------

def check_ext(path: str, ext: str) -> bool:
    return path.endswith(ext)


def add_ext(path: str, ext: str) -> str:
    return path + ext


def rm_ext(path: str) -> str:
    """Strip the last '.'-suffix; no-op if there is no '.' (extensions.c:49-65)."""
    dot = path.rfind(".")
    return path[:dot] if dot >= 0 else path


# ---------------------------------------------------------------------------
# .freq
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FreqFile:
    mode: str  # 'R' (histogram of the RLE stream) or 'N' (of the original)
    block_sizes: list[int]  # size of the stream each histogram was computed on
    freqs: list[list[int]]  # per block, 256 counts

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)


def _encode_elided_freqs(freq: Sequence[int]) -> str:
    """Frequency elision exactly as write_freq (f.c:94-110)."""
    if len(freq) != NUM_SYMBOLS:
        raise ValueError("need 256 frequencies")
    out = []
    i = 0
    while i < NUM_SYMBOLS:
        out.append(str(freq[i]))
        j = i
        while j < NUM_SYMBOLS and freq[j] == freq[i]:
            if j != NUM_SYMBOLS - 1:
                out.append(";")
            j += 1
        i = j
    return "".join(out)


def _decode_elided_freqs(token: str) -> list[int]:
    """Inverse of the elision (reader semantics: t.c:27-65)."""
    parts = token.split(";")
    freqs: list[int] = []
    prev = None
    for p in parts:
        if p == "":
            if prev is None:
                raise FileUnrecognizableError("freq block starts with ';'")
            freqs.append(prev)
        else:
            if not p.isdigit():
                raise FileUnrecognizableError(f"bad frequency token {p!r}")
            prev = int(p)
            freqs.append(prev)
    if len(freqs) != NUM_SYMBOLS:
        raise FileUnrecognizableError(
            f"freq block has {len(freqs)} entries, expected {NUM_SYMBOLS}"
        )
    return freqs


def write_freq(fp: IO[bytes], mode: str, block_sizes: Sequence[int],
               freqs: Sequence[Sequence[int]]) -> None:
    if mode not in ("R", "N"):
        raise ValueError("mode must be 'R' or 'N'")
    fp.write(f"@{mode}@{len(block_sizes)}".encode("ascii"))
    for size, f in zip(block_sizes, freqs):
        fp.write(f"@{size}@".encode("ascii"))
        fp.write(_encode_elided_freqs(f).encode("ascii"))
    fp.write(b"@0")


def parse_freq(data: bytes) -> FreqFile:
    text = data.decode("ascii", errors="strict")
    m = re.match(r"@([RN])@(\d+)", text)
    if not m:
        raise FileUnrecognizableError(".freq header")
    mode, n_blocks = m.group(1), int(m.group(2))
    body = text[m.end():]
    tokens = body.split("@")
    # body starts with '@' -> tokens[0] == ''; then (size, payload) pairs; then '0'.
    if len(tokens) < 1 + 2 * n_blocks + 1 or tokens[0] != "":
        raise FileUnrecognizableError(".freq structure")
    sizes, freqs = [], []
    for b in range(n_blocks):
        sizes.append(int(tokens[1 + 2 * b]))
        freqs.append(_decode_elided_freqs(tokens[2 + 2 * b]))
    if tokens[1 + 2 * n_blocks] != "0":
        raise FileUnrecognizableError(".freq trailer")
    return FreqFile(mode, sizes, freqs)


def read_freq(path: str) -> FreqFile:
    with open(path, "rb") as fp:
        return parse_freq(fp.read())


def write_freq_arrays(fp: IO[bytes], mode: str, block_sizes,
                      freqs_2d) -> None:
    """Array-native .freq writer (same bytes as write_freq).

    Uses the C++ runtime when available; the Python writer is the fallback
    and the spec.
    """
    from . import runtime
    import numpy as np
    f = np.ascontiguousarray(freqs_2d, dtype=np.int64)
    data = runtime.write_freq(mode, block_sizes, f)
    if data is not None:
        fp.write(data)
        return
    write_freq(fp, mode, list(block_sizes), f.tolist())


def parse_freq_arrays(data: bytes):
    """bytes -> (mode, sizes list[int], freqs (n,256) int64 ndarray).

    Native fast path; falls back to parse_freq (which carries the exact
    error diagnostics) on unavailability or malformed input.
    """
    from . import runtime
    import numpy as np
    out = runtime.parse_freq(data)
    if out is not None:
        mode, sizes, freqs = out
        return mode, sizes.tolist(), freqs
    ff = parse_freq(data)
    return ff.mode, ff.block_sizes, np.asarray(ff.freqs, dtype=np.int64)


# ---------------------------------------------------------------------------
# .cod
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CodFile:
    mode: str
    block_sizes: list[int]  # decoded-stream size per block
    codes: list[list[str]]  # per block, 256 bit-strings ('' = absent symbol)

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)


def write_cod(fp: IO[bytes], mode: str, block_sizes: Sequence[int],
              codes: Sequence[Sequence[str]]) -> None:
    if mode not in ("R", "N"):
        raise ValueError("mode must be 'R' or 'N'")
    fp.write(f"@{mode}@{len(block_sizes)}".encode("ascii"))
    for size, c in zip(block_sizes, codes):
        if len(c) != NUM_SYMBOLS:
            raise ValueError("need 256 codes")
        fp.write(f"@{size}@".encode("ascii"))
        fp.write(";".join(c).encode("ascii"))
    fp.write(b"@0")


def parse_cod(data: bytes) -> CodFile:
    text = data.decode("ascii", errors="strict")
    m = re.match(r"@([RN])@(\d+)", text)
    if not m:
        raise FileUnrecognizableError(".cod header")
    mode, n_blocks = m.group(1), int(m.group(2))
    tokens = text[m.end():].split("@")
    if len(tokens) < 1 + 2 * n_blocks + 1 or tokens[0] != "":
        raise FileUnrecognizableError(".cod structure")
    sizes, codes = [], []
    for b in range(n_blocks):
        sizes.append(int(tokens[1 + 2 * b]))
        c = tokens[2 + 2 * b].split(";")
        if len(c) != NUM_SYMBOLS:
            raise FileUnrecognizableError(
                f".cod block {b} has {len(c)} codes, expected {NUM_SYMBOLS}"
            )
        for s in c:
            if s.strip("01"):
                raise FileUnrecognizableError(f"bad code {s!r}")
        codes.append(c)
    if tokens[1 + 2 * n_blocks] != "0":
        raise FileUnrecognizableError(".cod trailer")
    return CodFile(mode, sizes, codes)


def read_cod(path: str) -> CodFile:
    with open(path, "rb") as fp:
        return parse_cod(fp.read())


def write_cod_tables(fp: IO[bytes], mode: str, block_sizes, tables) -> None:
    """Array-native .cod writer taking a codes.CodeTables (same bytes as
    write_cod on the equivalent strings)."""
    from . import runtime
    if not tables.overflow:
        data = runtime.write_cod(mode, block_sizes, tables.lens, tables.vals)
        if data is not None:
            fp.write(data)
            return
    write_cod(fp, mode, list(block_sizes), tables.to_strings())


def parse_cod_tables(data: bytes):
    """bytes -> (mode, sizes list[int], codes.CodeTables).

    Native fast path; the Python parser handles unavailability, malformed
    input (exact diagnostics), and >64-bit codes (CodeTables.overflow).
    """
    from . import runtime
    from .codes import CodeTables
    out = runtime.parse_cod(data)
    if out is not None:
        mode, sizes, lens, vals = out
        return mode, sizes.tolist(), CodeTables(lens, vals)
    cf = parse_cod(data)
    return cf.mode, cf.block_sizes, CodeTables.from_strings(cf.codes)


# ---------------------------------------------------------------------------
# .shaf
# ---------------------------------------------------------------------------

def write_shaf_header(fp: IO[bytes], n_blocks: int) -> None:
    fp.write(f"@{n_blocks}".encode("ascii"))


def write_shaf_block(fp: IO[bytes], payload: bytes) -> None:
    fp.write(f"@{len(payload)}@".encode("ascii"))
    fp.write(payload)


def iter_shaf_blocks(data: bytes) -> Iterator[bytes]:
    """Parse a .shaf byte string; yields per-block packed payloads."""
    m = re.match(rb"@(\d+)", data)
    if not m:
        raise FileUnrecognizableError(".shaf header")
    n_blocks = int(m.group(1))
    pos = m.end()
    for _ in range(n_blocks):
        m = re.compile(rb"@(\d+)@").match(data, pos)
        if not m:
            raise FileUnrecognizableError(".shaf block header")
        size = int(m.group(1))
        pos = m.end()
        if pos + size > len(data):
            raise FileUnrecognizableError(".shaf truncated block")
        yield data[pos:pos + size]
        pos += size
    if pos != len(data):
        raise FileUnrecognizableError(".shaf trailing bytes")


def read_shaf(path: str) -> list[bytes]:
    with open(path, "rb") as fp:
        return list(iter_shaf_blocks(fp.read()))


def iter_shaf_frames_file(fp: IO[bytes]) -> Iterator[bytes]:
    """Incrementally yield .shaf payloads from an open file.

    Streaming sibling of iter_shaf_blocks: only one frame (plus a small
    header buffer) is resident at a time — the bounded-memory decode path's
    reader (reference behavior: one block per loop iteration, d.c:694-763).
    """
    buf = b""

    def fill(pattern, allow_edge):
        # Grow buf until the pattern matches completely. A match ending at
        # the buffer edge is ambiguous for patterns ending in digits (more
        # digits could follow), so those re-read unless at EOF.
        nonlocal buf
        while True:
            m = pattern.match(buf)
            if m and (allow_edge or m.end() < len(buf)):
                return m
            more = fp.read(64)
            if not more:
                if m:
                    return m
                raise FileUnrecognizableError(".shaf frame header")
            buf += more

    m = fill(re.compile(rb"@(\d+)"), allow_edge=False)
    n_blocks = int(m.group(1))
    buf = buf[m.end():]
    hdr = re.compile(rb"@(\d+)@")
    for _ in range(n_blocks):
        m = fill(hdr, allow_edge=True)
        size = int(m.group(1))
        buf = buf[m.end():]
        if len(buf) < size:
            rest = fp.read(size - len(buf))
            if len(rest) != size - len(buf):
                raise FileUnrecognizableError(".shaf truncated block")
            payload = buf + rest
            buf = b""
        else:
            payload = buf[:size]
            buf = buf[size:]
        yield payload
    if buf or fp.read(1):
        raise FileUnrecognizableError(".shaf trailing bytes")


def parse_shaf_frames(data: bytes) -> list[bytes]:
    """All block payloads of a .shaf byte string (native frame scan when
    available; same result as list(iter_shaf_blocks(data))). The payloads
    are slices of data: copies of bytes, views of a uint8 array."""
    from . import runtime
    out = runtime.parse_shaf(data)
    if out is not None:
        offs, sizes = out
        return [data[int(o):int(o) + int(s)] for o, s in zip(offs, sizes)]
    return list(iter_shaf_blocks(data))
