"""The plain reference of the benchmark: what the CLI must write.

Given the bytes of an input file and its block size, ``sidecars`` works out
the files that a compress (modules F, T and C) writes beside it, byte for
byte, and the file that the decompress of its archive (module D) restores,
from those bytes alone. Plain torch and NumPy, on any device; it imports
nothing of the program (``shafa_tpu_torch``) and takes none of its outputs.
Frozen copies of the port's own host arithmetic, each module naming its
original: ``rle`` (oracle.py), ``codes`` (codes.py), ``formats``
(formats.py), ``pack`` (oracle.py's pack, recast for whole files).

The flow is module F's, T's and C's (``shafa_tpu_torch/pipeline.py``,
``compress_pipeline``, without flags): RLE of every block; R mode, whose
streams are the RLE blocks, where block 0's RLE saves at least 5% of it
(f.c:250-257), and N mode, whose streams are the raw blocks, otherwise; the
histogram of each stream block (.freq), its Shannon-Fano codes (.cod) and
its packed bits (.shaf). The restored file is the input itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import codes, formats, pack, rle

RLE_GATE_RATIO = 0.05


@dataclasses.dataclass
class Sidecars:
    mode: str
    files: dict[str, bytes]   # suffix after the input's name -> bytes
    max_code_len: list[int]   # per block
    archive: str              # suffix of the .shaf, which D takes

    def route_counts(self) -> dict[str, int]:
        """Blocks by decode route: codes of at most 16 bits, or 17-32."""
        ln = np.asarray(self.max_code_len)
        return {"le16": int((ln <= 16).sum()),
                "17to32": int(((ln > 16) & (ln <= 32)).sum()),
                "over32": int((ln > 32).sum())}


def _code_arrays(block_codes: list[list[str]], device):
    """(n, 256) lengths, first min(len, 32) bits and the bits after 32."""
    n = len(block_codes)
    lens = np.zeros((n, 256), np.int64)
    hi = np.zeros((n, 256), np.int64)
    lo = np.zeros((n, 256), np.int64)
    for i, cs in enumerate(block_codes):
        for s, c in enumerate(cs):
            if c:
                lens[i, s] = len(c)
                hi[i, s] = int(c[:32], 2)
                if len(c) > 32:
                    lo[i, s] = int(c[32:], 2)
    return tuple(torch.from_numpy(a).to(device) for a in (lens, hi, lo))


def sidecars(data: np.ndarray, block_size: int, device="cpu",
             tie_break: str = "symbol") -> Sidecars:
    """The compress's files for the input ``data`` (uint8) at
    ``block_size``; ``tie_break`` as in ``codes.build_codes``."""
    n = int(data.size)
    n_blocks = -(-n // block_size)
    sizes = [block_size] * (n_blocks - 1) + [n - block_size * (n_blocks - 1)]
    x = torch.from_numpy(np.require(data, np.uint8, ["C", "W"])).to(device)
    enc, enc_block, enc_sizes = rle.encode(x, block_size)
    if (sizes[0] - enc_sizes[0]) / sizes[0] >= RLE_GATE_RATIO:
        mode, stream, block, stream_sizes = "R", enc, enc_block, enc_sizes
        prefix = ".rle"
    else:
        mode, stream, stream_sizes, prefix = "N", x, sizes, ""
        block = torch.arange(n, device=device) // block_size
        del enc, enc_block
    hists = rle.histograms(stream, block, n_blocks).cpu().numpy()
    block_codes = [codes.build_codes(h, tie_break) for h in hists]
    lens, hi, lo = _code_arrays(block_codes, device)
    payloads = pack.pack(stream, block, n_blocks, lens, hi, lo)
    files = {}
    if mode == "R":
        files[".rle"] = stream.cpu().numpy().tobytes()
    files[prefix + ".freq"] = formats.freq_bytes(mode, stream_sizes,
                                                 hists.tolist())
    files[prefix + ".cod"] = formats.cod_bytes(mode, stream_sizes,
                                               block_codes)
    files[prefix + ".shaf"] = formats.shaf_bytes(payloads)
    return Sidecars(mode, files,
                    [max(map(len, cs)) for cs in block_codes],
                    prefix + ".shaf")
