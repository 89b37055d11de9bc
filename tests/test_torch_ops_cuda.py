"""The op sweep on the card: every op of the port's registry run on the
GPU against the same call on the CPU, both through the port
(tests/_torch_sweep_cases.py: forward and gradient within the parity
tests' stated tolerances, IEEE f32 with TF32 off, every output Tensor on
the card), and every op that draws held to its properties on the card.
chip_smoke.py's ops_sweep phase runs the same table.  Marked ``cuda``;
without a card it skips.  On the card:

    python -m pytest tests/test_torch_ops_cuda.py --noconftest -q
"""
import pytest
import torch

import _torch_sweep_cases as S

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def pp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep compares the card with "
                    "the CPU)")
    import paddle_tpu_torch as pp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops import _build
    _build.build(["flash_attention", "fused_norms"])
    return pp


@pytest.mark.parametrize("name", sorted(S.CASES))
def test_op_on_the_card_matches_the_cpu(pp, name):
    ref = S.run(pp, name, "cpu")
    got = S.run(pp, name, "gpu")
    assert S.compare(name, ref, got) == []
    assert all(d == "cuda" for d in got.devices), got.devices


@pytest.mark.parametrize("name", sorted(S.RANDOM))
def test_draw_properties_on_the_card(pp, name):
    assert S.check_random(pp, name, "gpu") == []
