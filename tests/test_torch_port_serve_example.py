"""The port's serving entry point (``examples/serve_gpt2.py``) on the CPU.

At a tiny size it serves plain, paged with a shared prefix, and
speculatively, returns 0 and prints the reference script's summary lines;
the options that are not ported yet raise, naming their ROADMAP items.
"""

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


@pytest.mark.parametrize("extra,item", [(["--ckpt-dir", "/nonexistent"],
                                         "A.15c"),
                                        (["--tp", "2"], "A.15c"),
                                        (["--dp", "2"], "A.15c")])
def test_unported_options_raise(extra, item):
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        serve_gpt2.main(TINY + extra)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gpt2.main(argv)
