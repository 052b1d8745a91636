"""The backward kernel of ``csrc/flash_attention.cu`` on the card.  Marked
``card``: each test skips, inside its fixture, where there is no CUDA
device.  On the card, from the repository's root (``--noconftest``: the
tests' shared fixtures import JAX, which that machine does not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m card \\
        tests/test_torch_flash_backward_card.py

The comparison with the plain blocked backward is ``chip_smoke.py``'s
phase 11c, run here as it is there, under its one tolerance
(``chip_smoke.BWD_TOL``).  Imports neither JAX nor the JAX package.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_route, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
def test_backward_kernel_matches_plain_and_repeats(card):
    """Phase 11c: over phase 11's sweep and at qwen3-8b's training shape
    (causal and with a window), each gradient within ``BWD_TOL`` of the
    plain backward's, two calls equal bit for bit, one launch a call."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    worst = chip_smoke.phase_flash_bwd_vs_plain()
    assert all(worst[k] <= chip_smoke.BWD_TOL[k] for k in worst), worst


@pytest.mark.card
@pytest.mark.parametrize("dtype,D", [(torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_float32_and_head_dim_256_take_the_plain_route(card, dtype, D):
    """float32 and D = 256 (gemma3-12b) run the plain backward on the card,
    counted by ``plain_calls``, not ``launches``."""
    g = torch.Generator().manual_seed(D)
    q, d_out = (torch.randn((1, 4, 64, D), generator=g) for _ in range(2))
    k, v = (torch.randn((1, 2, 64, D), generator=g) for _ in range(2))
    q, k, v, d_out = (t.to(dtype).to(card) for t in (q, k, v, d_out))
    out, lse = flash_attention_fwd(q, k, v)
    assert bwd_route(q) == "plain"
    before = (flash_attention_bwd.launches, flash_attention_bwd.plain_calls)
    got = flash_attention_bwd(q, k, v, out, lse, d_out)
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.plain_calls) == (before[0], before[1] + 1)
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, out, lse, d_out)):
        assert torch.equal(a, b)
