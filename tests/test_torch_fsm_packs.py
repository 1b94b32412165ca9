"""K7 in shafa_tpu_torch: the 8- and 16-state machine that writes symbol
packs (fsm_packs, plain on the CPU) against the JAX package's
_stage2_chain_ls in interpret mode on the planes of its rank kernel, the v4
chain (decode_batch_packs) against the NumPy oracle and the port's K2 -> K3
route, and the port of bench_decode_stages.py run on the CPU. Payloads stay
under 16 KiB per row; every comparison is exact."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shafa_tpu import codes as codes_mod, oracle
from shafa_tpu.kernels import decode as jdec
from shafa_tpu_torch.device import _bucket, _stack_blocks, tables_to_device
from shafa_tpu_torch.kernels import decode

REPO = pathlib.Path(__file__).resolve().parent.parent


def _canonical_rows(lens_list, n_rows):
    """CodeTables rows of a complete canonical code with these lengths."""
    lens = np.zeros((n_rows, 256), np.uint8)
    vals = np.zeros((n_rows, 256), np.uint64)
    code = prev = 0
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        lens[:, s] = ln
        vals[:, s] = np.uint64(code) << np.uint64(64 - ln)
        code += 1
        prev = ln
    return codes_mod.CodeTables(lens, vals)


def _batch(s_states, rng):
    """Three rows whose longest code fits s_states: at 8 states, every code
    8 bits, codes of at most 3 bits and a 13-symbol alphabet; at 16 states,
    tables of about 6, 9 and 12 bits. Row 0 decodes fewer symbols than it
    holds (a ragged count); row 1's payload is cut in half (underrun)."""
    if s_states == 8:
        b0 = np.tile(np.arange(256, dtype=np.uint8), 40)
        rng.shuffle(b0)
        blocks = [b0, rng.integers(0, 5, 12_000).astype(np.uint8),
                  rng.integers(97, 110, 9000).astype(np.uint8)]
        tables = codes_mod.build_code_tables(
            np.stack([oracle.histogram(b) for b in blocks]))
    else:
        blocks = [rng.integers(0, 40, 12_000).astype(np.uint8),
                  rng.integers(0, 10, 12_000).astype(np.uint8),
                  rng.integers(0, 13, 11_000).astype(np.uint8)]
        t6 = codes_mod.build_code_tables(oracle.histogram(blocks[0])[None])
        t9 = _canonical_rows(list(range(1, 9)) + [9, 9], 1)
        t12 = _canonical_rows(list(range(1, 12)) + [12, 12], 1)
        tables = codes_mod.CodeTables(
            np.concatenate([t6.lens, t9.lens, t12.lens]),
            np.concatenate([t6.vals, t9.vals, t12.vals]))
    maxlen = tables.lens.max(axis=1)
    assert (maxlen <= s_states).all() and int(maxlen.max()) > s_states // 2
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    payloads[1] = payloads[1][: len(payloads[1]) // 2]
    assert max(map(len, payloads)) <= 16 << 10
    counts = np.array([4000, blocks[1].size, blocks[2].size], np.int32)
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    return tables, blocks, payloads, counts, st, plens


@pytest.fixture(scope="module", params=[8, 16])
def batch(request):
    """The batch at 8 or 16 states, K2's planes from the port (plain) and
    from the JAX package's Pallas kernel (interpret mode), and K7's packs
    from both."""
    s_states = request.param
    tables, blocks, payloads, counts, st, plens = _batch(
        s_states, np.random.default_rng(s_states))
    b, p = st.shape
    dt = tables_to_device(tables, "cpu", decode=True)
    planes = decode.rank_planes(torch.from_numpy(st), dt.pc16, dt.ls,
                                dt.lut12)
    jplanes = jdec.rank_planes_pallas(
        jdec.windows32_bytes(st), *jdec.rank_tables(
            jdec.decode_tables_batch(tables.lens, tables.vals)),
        interpret=True)
    want = jdec._stage2_chain_ls(jplanes, b, p, jnp.asarray(plens),
                                 jnp.asarray(counts), s_states,
                                 interpret=True)
    return dict(s_states=s_states, tables=tables, blocks=blocks,
                payloads=payloads, counts=counts, st=st, plens=plens, dt=dt,
                planes=planes, jplanes=np.array(jplanes),
                want=[np.asarray(w) for w in want])


def test_fsm_packs_match_pallas(batch):
    """K7's interleaved packs (lane 2j: byte j's first pack, 2j + 1: its
    second) and underrun flags against the four arrays of _stage2_chain_ls
    on the JAX kernel's planes (equal to the port's): lanes within each
    row's payload equal (the JAX kernel leaves the tiles past it
    unwritten); the port's lanes past it are zero."""
    np.testing.assert_array_equal(batch["planes"].numpy(), batch["jplanes"])
    got = decode.fsm_packs(torch.from_numpy(batch["jplanes"]),
                           torch.from_numpy(batch["plens"]),
                           torch.from_numpy(batch["counts"]),
                           batch["s_states"])
    want = batch["want"]
    p = batch["st"].shape[1]
    valid = np.arange(p)[None, :] < batch["plens"][:, None]
    assert got[0].shape == got[1].shape == (batch["st"].shape[0], 2 * p)
    lanes = [got[0][:, 0::2], got[0][:, 1::2], got[1][:, 0::2],
             got[1][:, 1::2]]
    for g, w in zip(lanes, want[:4]):
        np.testing.assert_array_equal(g.numpy()[valid], w[valid])
        assert not g.numpy()[~valid].any()
    np.testing.assert_array_equal(got[2].numpy(), want[4])
    assert got[2].tolist() == [False, True, False]


def test_decode_batch_packs_matches_oracle_and_k3(batch):
    args = (torch.from_numpy(batch["st"]), torch.from_numpy(batch["plens"]),
            batch["dt"].pc16, batch["dt"].ls, batch["dt"].lut12,
            torch.from_numpy(batch["counts"]),
            _bucket(int(batch["counts"].max())), batch["s_states"])
    out, under = decode.decode_batch_packs(*args)
    k3_out, k3_under = decode.decode_batch(*args)
    assert torch.equal(out, k3_out) and torch.equal(under, k3_under)
    assert under.tolist() == [False, True, False]
    for i in (0, 2):
        n = int(batch["counts"][i])
        want = oracle.unpack(batch["payloads"][i],
                             batch["tables"].row_strings(i), n)
        np.testing.assert_array_equal(out[i, :n].numpy(), want)
        np.testing.assert_array_equal(want, batch["blocks"][i][:n])
        assert not out[i, n:].numpy().any()


def test_emit_packs_matches_pallas(batch):
    """K1 on the port's K7 packs against _emit_packs on the JAX kernel's,
    over each row's decoded symbols."""
    counts, plens = batch["counts"], batch["plens"]
    stride_words = max(_bucket(int(counts.max())), 512) // 4
    vals, lens, _ = decode.fsm_packs(batch["planes"], torch.from_numpy(plens),
                                     torch.from_numpy(counts),
                                     batch["s_states"])
    got = decode.emit_packs(vals, lens, torch.from_numpy(plens),
                            stride_words)
    want = np.asarray(jdec._emit_packs(
        *map(jnp.asarray, batch["want"][:4]), jnp.asarray(plens),
        stride_words, True))
    assert got.shape == want.shape
    kept = (lens.sum(1) // 8).tolist()
    assert kept[::2] == counts.tolist()[::2] and 0 < kept[1] < counts[1]
    for i, n in enumerate(kept):
        np.testing.assert_array_equal(got[i, :n].numpy(), want[i, :n])


@pytest.mark.parametrize("s_states", [0, 4, 12, 32])
def test_fsm_packs_rejects_other_state_counts(s_states):
    planes = torch.zeros((8, 1024), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="8 or 16"):
        decode.fsm_packs(planes, one, one, s_states)


#: runs the bench port at 1 MiB in 256 KiB blocks and prints its exit code
#: and the names of any shafa_tpu or jax module that got loaded
BENCH = r"""
import json, sys
from shafa_tpu_torch import bench_decode_stages
rc = bench_decode_stages.main(["1048576", "262144"])
print(json.dumps([rc, sorted(m for m in sys.modules if m == "jax"
                             or m.startswith(("jax.", "jaxlib"))
                             or m.split(".")[0] == "shafa_tpu")]))
"""


def test_bench_decode_stages_runs_on_the_cpu():
    """At 1 MiB with every branch on: SHAFA_BENCH_V3 adds K6 on K2's
    planes and its check against K7's packs."""
    env = dict(os.environ, SHAFA_TORCH_DEVICE="cpu", SHAFA_BENCH_REPS="1",
               SHAFA_BENCH_V3="1", SHAFA_BENCH_XLA_EXPAND="1")
    r = subprocess.run([sys.executable, "-c", BENCH], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [0, []]
    stages = [ln.split("  ")[0] for ln in lines if " ms " in ln]
    assert stages == ["rank_planes (K2)", "fsm_v4 S=16 (K7)",
                      "fsm32 S=32 (K6)", "emit_packs (K1)",
                      "fused v5 chain (K2, K3)", "expand_sizes",
                      "expand (K4)"]
    for check in ("K6 gives K7's packs", "K7 -> emit_packs gives K3's rows",
                  "K4 gives its plain version's bytes",
                  "the expanded bytes equal the corpus"):
        assert f"{check}: True" in lines
