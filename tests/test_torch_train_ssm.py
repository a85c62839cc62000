"""The port's training forward and loss against the JAX package's on the
CPU at smoke size (float32): Mamba2 (the SSD scan's plain chunked path,
which autograd differentiates; on the card the SSD kernel refuses a
gradient until it has a backward) and Whisper (encoder, causal decoder
and cross-attention).  Checks and tolerances: ``_torch_train.py``."""
import pytest

import _torch_train as tt
from _torch_parity import one_torch_thread  # noqa: F401

CASES = [("mamba2_370m", 48, {}),
         ("whisper_large_v3", 24, {})]


@pytest.fixture(scope="module", params=CASES,
                ids=[tt.case_id(*c) for c in CASES])
def case(request):
    return tt.make_case(*request.param)


def test_forward_train_matches_jax(case):
    tt.check_forward(case)


def test_loss_and_gradients_match_jax_value_and_grad(case):
    tt.check_grads(case)
