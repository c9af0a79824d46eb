"""BatchNorm under the sharded strategies takes its statistics over every
batch axis, on 4 gloo ranks.

A ResNet-18 (CIFAR stem, 8 filters, random BN running statistics, 16 x
16 images, global batch 16: 4 rows a rank) trained 2 SGD steps under
``HybridShard`` on ``(dcn=2, fsdp=2)`` and FSDP on ``(dp=2, fsdp=2)``
(``min_shard_size=8``, so the BN scales and biases shard too) equals
``DataParallel`` over the same 4 ranks: losses within rtol 1e-5,
parameters and running statistics within 1e-5 of each tensor's largest
element plus 1e-7 (the gradient sums run in another order). BatchNorm
over one axis's group alone would take the statistics of 8 rows, not 16.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_sharding as sh

torch.set_num_threads(2)

N = ranks.WORLD


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    jobs = [dict(tag=f"resnet_{k}", strategy=k, model="resnet",
                 state_dict=_resnet_state_dict(), batches=_images(2))
            for k in ("dp", "hybrid", "fsdp_dp")]
    ranks.finish(ranks.start(sh.rank_body, tmp, jobs))
    return {job["tag"]: sh.load(tmp, job["tag"], N) for job in jobs}


def _resnet_state_dict():
    from pytorch_distributed_tpu_torch.models import resnet18

    model = resnet18(10, cifar_stem=True, num_filters=8, device="cpu",
                     seed=3)
    g = torch.Generator().manual_seed(4)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=g) * 0.1)
        elif name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model.state_dict()


def _images(n, B=16):
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("kind", ["hybrid", "fsdp_dp"])
def test_batchnorm_takes_every_batch_axis(runs, kind):
    dp, sharded = runs["resnet_dp"], runs[f"resnet_{kind}"]
    for r in range(N):
        np.testing.assert_allclose(sharded[r]["metrics"]["loss"],
                                   dp[r]["metrics"]["loss"], rtol=1e-5)
    for name, p in sharded[0]["params"].items():
        w = dp[0]["params"][name]
        if not w.is_floating_point():
            assert torch.equal(p, w), name
            continue
        err = float((p - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()) + 1e-7, (name, err)
    assert sharded[0]["n_leaves_sharded"] > 0
