"""The port's LM training path against the reference's, on the CPU, for the
MoE (qwen2-moe-a2.7b), MLA over dense and MoE stacks with the MTP head
and an aux-loss-free router (deepseek-v3-671b), SSD (mamba2-780m) and
hybrid (hymba-1.5b) architectures at their SMOKE sizes, with the helpers
and bounds of ``test_torch_lm_train.py``: the loss, its metrics and
gradients in float32 and bfloat16, and remat. Their whole steps are in
``test_torch_lm_train_steps.py``, so that the two files' reference
compilations run on two workers.

MoE configs also hold the port's expert choices, call by call, to the
reference's: exactly in float32; in bfloat16 up to near ties
(``_route_mismatches``, the serving tests' rule: the router logits agree
within the bfloat16 bound and every expert either side chose is within
twice that bound of the k-th). deepseek-v3's router flips on one-ulp
differences, as in serving, and may do so anywhere. qwen2-moe's does
once at this batch, and only there is it allowed: at its second routing
call (the second MoE layer), token 4, the reference takes experts [5 6]
and the port [5 1], whose logits lie 0.0095 apart while the two
packages' logits of that call differ by up to 0.013 (bound 0.073).
"""

import numpy as np
import pytest

from test_torch_lm_train import check_loss_and_grads, check_remat

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "hymba-1.5b")
#: where bfloat16 routing may differ: anywhere, or at the measured (call, token)
NEAR_TIES = {"qwen2-moe-a2.7b": frozenset({(1, 4)}), "deepseek-v3-671b": True}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_the_reference(arch, dtype):
    gaps = check_loss_and_grads(arch, dtype, near_ties=dtype == "bfloat16" and NEAR_TIES.get(arch, False))
    if arch == "qwen2-moe-a2.7b":  # the load-balance statistic times moe_aux_alpha = 0.01
        assert gaps["aux"] <= 1e-5 and "mtp" not in gaps
    if arch == "deepseek-v3-671b":  # moe_aux_alpha = 0, and the MTP head at weight 0.3
        assert "mtp" in gaps


def test_the_auxiliary_loss_is_the_reference_statistic():
    """qwen2-moe's ``aux`` is 0.01 times the load-balance statistic of each
    of its MoE layers, summed; deepseek-v3's is 0; the others have none."""
    from test_torch_lm_train import _reference_loss_and_grads

    _, qwen, _, _ = _reference_loss_and_grads("qwen2-moe-a2.7b", "float32")
    _, deepseek, _, _ = _reference_loss_and_grads("deepseek-v3-671b", "float32")
    assert qwen["aux"] > 0 and np.isfinite(qwen["aux"])
    assert deepseek["aux"] == 0.0 and deepseek["mtp"] > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_leaves_the_gradients_unchanged(arch):
    check_remat(arch)
