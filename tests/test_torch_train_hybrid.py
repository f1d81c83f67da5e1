"""tests/test_torch_train.py's ``loss_fn`` checks on jamba-v0.1-52b, xlstm-350m,
gemma3-12b, mixtral-8x7b and stablelm-3b.

They run from this file, which the test workers take apart from the first
(jamba's and xlstm's references take the longest to compile); the tests,
bars and reference are that file's.
"""

import pytest

from test_torch_train import (  # noqa: F401  (collected here with this file's fixture)
    reference,
    test_bf16_loss_matches_the_reference,
    test_fp32_loss_and_every_gradient_match_the_reference,
    test_fp32_loss_matches_the_reference_in_both_chunking_branches,
    test_remat_block_gives_the_bits_of_none,
)

ARCHS = ["jamba_v01_52b", "xlstm_350m", "gemma3_12b", "mixtral_8x7b", "stablelm_3b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference(request.param)
