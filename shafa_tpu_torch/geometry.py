"""Block geometry: file size -> (n_blocks, block_size, last_block_size).

Copy of shafa_tpu/geometry.py:1-102.

Reproduces the invariant of the reference's fsize() (src/modules/utils/file.c:52-117):

    total = (n_blocks - 1) * block_size + size_of_last_block

with the quirk that an exactly-divisible file reports size_of_last_block ==
block_size (file.c:81), and the clamping rules (file.c:62-64): block size 0 ->
512 KiB default, < 512 B -> 512 B, > 64 MiB -> error.

Also carries the padding helpers that turn the reference's variable last block
into padded batch shapes: blocks are padded to a common padded size and
masked by their true lengths.
"""

from __future__ import annotations

import dataclasses
import os

# Block size constants (reference: src/modules/utils/file.h:6-12).
KiB1 = 1024
KiB64 = 65536
KiB640 = 655360
MiB8 = 8388608
MiB64 = 67108864

# fsize() clamps (reference: file.c:42-44).
DEFAULT_BLOCK_SIZE = 524288  # 512 KiB
MIN_BLOCK_SIZE = 512
MAX_BLOCK_SIZE = MiB64

#: CLI "-b" letter -> block size (reference: src/shafa.c:95-108).
BLOCK_SIZE_BY_FLAG = {"K": KiB640, "m": MiB8, "M": MiB64}

#: Default when no -b given. NOTE: the reference README claims K=640 KiB but the
#: code uses 64 KiB (src/shafa.c:304-305); we follow the code. [SURVEY.md §1/L4]
CLI_DEFAULT_BLOCK_SIZE = KiB64

#: Minimum input size accepted by module F (reference: src/modules/f.c:220,366).
MIN_FILE_SIZE = KiB1


class BlockSizeError(ValueError):
    """Block size exceeds the 64 MiB maximum (file.c:62)."""


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    n_blocks: int
    block_size: int
    last_block_size: int

    @property
    def total(self) -> int:
        return (self.n_blocks - 1) * self.block_size + self.last_block_size

    def sizes(self) -> list[int]:
        """Per-block true sizes, in file order."""
        if self.n_blocks == 0:
            return []
        return [self.block_size] * (self.n_blocks - 1) + [self.last_block_size]

    def offset(self, i: int) -> int:
        return i * self.block_size


def clamp_block_size(block_size: int) -> int:
    """Apply fsize()'s clamping rules (file.c:62-64)."""
    if block_size > MAX_BLOCK_SIZE:
        raise BlockSizeError(f"block size {block_size} > {MAX_BLOCK_SIZE}")
    if block_size == 0:
        return DEFAULT_BLOCK_SIZE
    if block_size < MIN_BLOCK_SIZE:
        return MIN_BLOCK_SIZE
    return block_size


def geometry_for_size(total: int, block_size: int) -> BlockGeometry:
    """Split a byte count into blocks, matching fsize() exactly (file.c:76-88)."""
    block_size = clamp_block_size(block_size)
    if total == 0:
        # fsize on an empty file: n_blocks=0, last=block_size (file.c:81 path).
        return BlockGeometry(0, block_size, block_size)
    n_blocks, rem = divmod(total, block_size)
    if rem == 0:
        last = block_size
    else:
        last = rem
        n_blocks += 1
    return BlockGeometry(n_blocks, block_size, last)


def geometry_for_file(path: str, block_size: int) -> BlockGeometry:
    """fsize() equivalent; os.stat replaces the reference's seek/ftell dance
    (including its >2 GiB fread fallback, file.c:91-108 — stat has no such limit)."""
    return geometry_for_size(os.stat(path).st_size, block_size)


def pad_to(n: int, multiple: int) -> int:
    """Round up to a multiple."""
    return -(-n // multiple) * multiple
