"""The CUDA tower kernel against its plain PyTorch version, on a card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
only torch and the port, so it also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops import tower

DIMS = ModelDims(n_users=2000, n_items=600, cat_dims=(("city", 6), ("hotel_type", 5)),
                 n_num_features=11)
TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX kernel's own parity bar


def _model_and_x0(n_res: int, variant: str, B: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    cfg = ModelConfig(emb_dim=48, hidden_dim=320, n_cross_layers=3, n_res_blocks=n_res,
                      cross_variant=variant)
    model = DCNR(DIMS, cfg, generator=g).eval()
    with torch.no_grad():  # non-trivial running statistics
        for block in model.res_blocks:
            for bn in (block.bn1, block.bn2):
                bn.mean.uniform_(-0.5, 0.5, generator=g)
                bn.var.uniform_(0.5, 2.0, generator=g)
    model = model.cuda()
    inputs = (
        torch.randint(0, DIMS.n_users, (B,), generator=g),
        torch.randint(0, DIMS.n_items, (B,), generator=g),
        torch.stack([torch.randint(0, 6, (B,), generator=g),
                     torch.randint(0, 5, (B,), generator=g)], dim=1),
        torch.rand(B, 11, generator=g),
    )
    with torch.no_grad():
        x0 = tower.build_x0(model, *(t.cuda() for t in inputs))
    return tower.fold_eval_params(model), x0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("n_res,B", [(3, 128), (0, 200), (2, 1), (3, 8192)])
def test_cuda_kernel_matches_plain_version(variant, n_res, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    f, x0 = _model_and_x0(n_res, variant, B)
    before = tower.tower_eval.launches
    with torch.no_grad():
        out = tower.tower_eval(f, x0, variant)
        torch.cuda.synchronize()
        assert tower.tower_eval.launches == before + 1
        ref = tower.tower_eval_ref(f, x0, variant)
        torch.testing.assert_close(out, ref, **TOL)
        # a row's logit does not depend on its position in the batch
        again = tower.tower_eval(f, x0.flip(0).contiguous(), variant).flip(0)
        assert torch.equal(again, out)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    f, x0 = _model_and_x0(1, "code", 16)
    with pytest.raises(TypeError, match="float32"):
        tower.tower_eval(f, x0.double())
    with pytest.raises(ValueError, match="contiguous"):
        tower.tower_eval(f, x0.t().contiguous().t())
    with pytest.raises(ValueError, match="features"):
        tower.tower_eval(f, x0[:, :-1].contiguous())
    with pytest.raises(ValueError, match="is on cpu"):
        tower.tower_eval(dict(f, b0=f["b0"].cpu()), x0)
