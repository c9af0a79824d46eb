"""The port's serving entry point (``examples/serve_gpt2.py``) on the CPU.

At a tiny size it serves plain, paged with a shared prefix, and
speculatively, returns 0 and prints the reference script's summary lines.
The options ported by ROADMAP A.15c serve: ``--ckpt-dir`` the weights of
a checkpoint that ``train_gpt2.py --ckpt-dir`` wrote, ``--tp 2`` and
``--dp 2`` on 2 gloo ranks (``tests/_torch_port_ranks.py``), rank 0
printing the same streams as one process.
"""

import contextlib
import io
import re

import pytest
import torch

from pytorch_distributed_tpu_torch.examples import serve_gpt2

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--layers", "2", "--embd", "32", "--heads", "4",
        "--vocab", "97", "--seq-len", "64", "--slots", "2",
        "--prefill-len", "16", "--requests", "3", "--max-new-tokens", "6"]


@pytest.mark.parametrize("extra,lines", [
    ([], []),
    (["--cache", "paged", "--page-size", "4", "--shared-prefix", "8"],
     [r"paged KV cache: page_size=4, 33 pages \(32 allocatable \+ trash\)",
      r"paged cache: radix hits 2 / misses 1, \d+/\d+ prefill tokens served "
      r"from cache \(\d+%\), \d+ pages free"]),
    (["--spec-k", "2", "--cache", "paged", "--page-size", "4"],
     [r"speculative decoding: k=2, self-draft 1/2 layers",
      r"spec k=2: accept-rate [\d.]+%, [\d.]+ tokens per target forward "
      r"\(batch-wide\)"]),
    (["--spec-k", "2", "--temperature", "0.8", "--top-k", "10"],
     [r"spec k=2: accept-rate"]),
], ids=["plain", "paged_shared_prefix", "spec", "spec_sampled"])
def test_serve_example_runs_and_reports(capsys, extra, lines):
    assert serve_gpt2.main(TINY + extra) == 0
    out = capsys.readouterr().out
    assert "serving RANDOM weights (no --ckpt-dir)" in out
    assert len(re.findall(r"^req \d+: prompt \d+ tok -> \+6 \[length\]", out,
                          re.M)) == 3
    assert re.search(r"served 3 requests, 18 tokens in [\d.]+s "
                     r"\([\d.]+ tok/s\)", out)
    assert re.search(r"decode step p50 [\d.]+ms p99 [\d.]+ms \| "
                     r"ttft p50 [\d.]+ms", out)
    for line in lines:
        assert re.search(line, out), line


def _served(rank, store_dir, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_gpt2.main(argv) == 0
    with open(f"{store_dir}/out{rank}.txt", "w") as f:
        f.write(buf.getvalue())


def _streams(out):
    return sorted(re.findall(r"^req \d+: .*\| (.*)$", out, re.M))


@pytest.mark.parametrize("extra,item", [(["--ckpt-dir", "/nonexistent"],
                                         "A.15c"),
                                        (["--tp", "2"], "A.15c"),
                                        (["--dp", "2"], "A.15c")])
def test_unported_options_raise(extra, item, tmp_path, capsys):
    """The options that raised until ROADMAP A.15c was ported now serve."""
    from tests import _torch_port_ranks as ranks

    serve_gpt2.main(TINY)
    plain = capsys.readouterr().out
    if extra[0] == "--ckpt-dir":
        from tests import _torch_port_tp as tph

        # train and serve in processes of their own, each its own group
        ckpt = tmp_path / "ckpt"
        ranks.finish(ranks.start(tph.train_ckpt_body, tmp_path, TINY[:10] + [
            "--seq-len", "64", "--global-batch", "2", "--steps", "2",
            "--dataset-size", "4", "--ckpt-dir", str(ckpt)], world=1))
        ranks.finish(ranks.start(_served, tmp_path,
                                 TINY + ["--ckpt-dir", str(ckpt)], world=1))
        out = (tmp_path / "out0.txt").read_text()
        assert f"loaded params from {ckpt} (step 2)" in out
        assert re.search(r"served 3 requests, 18 tokens", out)
        return
    ctx = ranks.start(_served, tmp_path, TINY + extra, world=2)
    ranks.finish(ctx)
    out0 = (tmp_path / "out0.txt").read_text()
    assert (tmp_path / "out1.txt").read_text() == ""     # rank 0 prints
    mesh = "{'dp': 1, 'tp': 2}" if extra[0] == "--tp" else "{'dp': 2, 'tp': 1}"
    assert f"serving mesh {mesh}" in out0
    assert re.search(r"served 3 requests, 18 tokens", out0)
    assert _streams(out0) == _streams(plain)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gpt2.main(argv)
