"""The sidecar formats, written from plain values.

Frozen copy of the writers of ``shafa_tpu_torch/formats.py``
(``_encode_elided_freqs``, ``write_freq``, ``write_cod``,
``write_shaf_header``, ``write_shaf_block``; themselves copies of
``shafa_tpu/formats.py``), returning bytes:

  .freq  "@R@<n>" | "@N@<n>", per block "@<size>@" and the 256 counts with
         equal neighbours elided (f.c:94-110), then "@0";
  .cod   the same header, per block "@<size>@" and the 256 codes joined by
         ';' (t.c:350-362), then "@0";
  .shaf  "@<n>", per block "@<payload size>@<payload>", no trailer.
"""

from __future__ import annotations

NUM_SYMBOLS = 256


def _elided(freq) -> str:
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


def freq_bytes(mode: str, sizes, freqs) -> bytes:
    parts = [f"@{mode}@{len(sizes)}"]
    for size, f in zip(sizes, freqs):
        parts.append(f"@{size}@{_elided(f)}")
    parts.append("@0")
    return "".join(parts).encode("ascii")


def cod_bytes(mode: str, sizes, codes) -> bytes:
    parts = [f"@{mode}@{len(sizes)}"]
    for size, c in zip(sizes, codes):
        parts.append(f"@{size}@" + ";".join(c))
    parts.append("@0")
    return "".join(parts).encode("ascii")


def shaf_bytes(payloads) -> bytes:
    parts = [f"@{len(payloads)}".encode("ascii")]
    for p in payloads:
        parts.append(f"@{len(p)}@".encode("ascii"))
        parts.append(p)
    return b"".join(parts)
