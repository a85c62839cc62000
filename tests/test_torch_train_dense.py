"""The port's training forward and loss against the JAX package's on the
CPU at smoke size (float32): StarCoder2 through the naive attention
branch without remat and through the chunked branch (S 300) with it,
OLMoE (the MoE aux loss) and DeepSeek-V3 (MLA and multi-token
prediction).  Checks and tolerances: ``_torch_train.py``."""
import pytest

import _torch_train as tt
from _torch_parity import one_torch_thread  # noqa: F401

# (arch, S, config changes): S = 300 takes the chunked attention branch
CASES = [("starcoder2_3b", 300, {}),
         ("starcoder2_3b", 32, {"remat": False}),
         ("olmoe_1b_7b", 32, {}),
         ("deepseek_v3_671b", 32, {})]


@pytest.fixture(scope="module", params=CASES,
                ids=[tt.case_id(*c) for c in CASES])
def case(request):
    return tt.make_case(*request.param)


def test_forward_train_matches_jax(case):
    tt.check_forward(case)


def test_loss_and_gradients_match_jax_value_and_grad(case):
    tt.check_grads(case)
