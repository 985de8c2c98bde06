"""One whole float32 ``make_train_step`` step of the MoE, MLA, SSD and
hybrid architectures at their SMOKE sizes against the reference's step,
with 1 and 2 microbatches, under the bounds of ``test_torch_lm_train.py``
(whose helper runs it).
"""

import pytest

from test_torch_lm_train import check_train_step
from test_torch_lm_train_families import FAMILY_ARCHS


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_the_reference(arch, microbatches):
    check_train_step(arch, microbatches)
