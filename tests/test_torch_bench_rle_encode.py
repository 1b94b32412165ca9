"""bench_rle_encode (K8 timed at the main paths' shapes) on the CPU: it
refuses to time without a card, refuses --tree outside its file form, and
its batches and bytes bound, built here at a small size with K8's plain
version, match the JAX package's oracle."""

import numpy as np
import torch

from shafa_tpu import oracle
from shafa_tpu_torch import bench_rle_encode
from shafa_tpu_torch.kernels import rle
from shafa_tpu_torch.profile_main_path import synthetic, text_with_rare_bytes


def test_without_a_card_main_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_rle_encode.main([]) == 1
    assert "CUDA device not available" in capsys.readouterr().err


def test_tree_needs_the_file_form(capsys):
    assert bench_rle_encode.main(["--tree", "elsewhere"]) == 2
    assert "file form" in capsys.readouterr().err


def test_batches_and_bytes_bound_on_the_cpu():
    block, rows = 4096, 4
    mixed = synthetic(rows * block + 100, 0)
    text = text_with_rare_bytes(rows * block + 100)
    shapes = bench_rle_encode.batches(mixed, text, "cpu", block, rows)
    assert {k: list(x.shape) for k, (x, _) in shapes.items()} == {
        "mixed": [rows, block], "text": [rows, block],
        "row": [1, rows * block]}
    for name, data in (("mixed", mixed), ("text", text),
                       ("row", mixed[:rows * block])):
        x, lengths = shapes[name]
        enc, out_len, hist = rle.rle_encode_hist(x, lengths)
        size = block if name != "row" else rows * block
        want = [oracle.rle_encode(np.frombuffer(data, np.uint8, size,
                                                i * size))
                for i in range(x.shape[0])]
        assert out_len.tolist() == [w.size for w in want]
        assert bench_rle_encode.exact((enc, out_len, hist), (
            torch.from_numpy(np.stack([np.pad(w, (0, enc.shape[1] - w.size))
                                       for w in want])),
            out_len, torch.from_numpy(np.stack([oracle.histogram(w)
                                                for w in want]))))
        assert bench_rle_encode.bound_bytes(lengths, out_len, hist) == (
            x.shape[0] * size + 4 * x.shape[0] + sum(w.size for w in want)
            + 8 * x.shape[0] + 8 * 256 * x.shape[0])
