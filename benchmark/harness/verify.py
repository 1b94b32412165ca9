"""The comparison that decides ``correct``.

Every call of the window (and each process's warm-up round trip) is judged
once the window has closed, by what it wrote: each file of a compress
against the plain reference's file for the same pool file
(``reference.sidecars``), and the file each decompress restored against
the pool file itself. Outputs were hashed (blake2b, 128 bits) as the calls
wrote them; the reference's are hashed here. Every number compared is a
count, and its limit is 0:

  failed_calls       calls whose cli.main returned non-zero or raised, or
                     that a failed process never made
  rle_mismatch       .rle files that differ from the reference's (or miss)
  freq_mismatch      .freq files (.rle.freq in R mode)
  cod_mismatch       .cod files
  shaf_mismatch      .shaf files, the archives
  restored_mismatch  restored files that differ from their input (or miss)
  stray_files        files a compress left that the reference does not write
  pool_modified      pool files whose bytes changed during the run
  calls_unjudged     1 when the window made no round trip, else 0
"""

from __future__ import annotations

import hashlib

import numpy as np

import reference

LIMITS = {"failed_calls": 0, "rle_mismatch": 0, "freq_mismatch": 0,
          "cod_mismatch": 0, "shaf_mismatch": 0, "restored_mismatch": 0,
          "stray_files": 0, "pool_modified": 0, "calls_unjudged": 0}


def digest_bytes(data: bytes) -> list:
    """[size, blake2b hex], as calls.digest gives it for a file."""
    return [len(data), hashlib.blake2b(data, digest_size=16).hexdigest()]


def expected(pool: list, block_size: int, device, tie_break: str = "symbol"
             ) -> tuple[list[dict], list]:
    """Per pool file (bytes or a uint8 array), {suffix: [size, hash]} of
    the compress's files and "restored"; and each file's
    reference.Sidecars (mode, code lengths; its files dropped)."""
    want, side = [], []
    for data in pool:
        arr = np.frombuffer(data, np.uint8) if isinstance(data, bytes) \
            else data
        sc = reference.sidecars(arr, block_size, device, tie_break)
        d = {suffix: digest_bytes(b) for suffix, b in sc.files.items()}
        d["restored"] = digest_bytes(arr.tobytes())
        sc.files = {}
        want.append(d)
        side.append(sc)
    return want, side


def judge(calls: list, want: list[dict]) -> dict:
    """The numbers compared, by name (pool_modified is the caller's)."""
    out = dict.fromkeys(LIMITS, 0)
    out["failed_calls"] = sum(c.rc != 0 for c in calls)
    out["calls_unjudged"] = int(not calls)
    for c in calls:
        w = want[c.pool_index]
        got = {k: list(v) for k, v in c.outputs.items()}
        if c.direction == "decompress":
            out["restored_mismatch"] += got.get("restored") != w["restored"]
            continue
        for suffix, digest in w.items():
            if suffix != "restored":
                kind = suffix.rsplit(".", 1)[-1]
                out[f"{kind}_mismatch"] += got.get(suffix) != digest
        out["stray_files"] += len(set(got) - set(w))
    return out


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
