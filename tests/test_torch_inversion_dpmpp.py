"""``test_torch_inversion.py``'s guided sampling against JAX through
DPM-Solver++(2M): the same tiny SD decoder, embeddings and checks, in a
file of its own so that a ``--dist loadfile`` run spreads the two
samplers' cases over two workers."""

import pytest

from tests.test_torch_inversion import _check_guided_sampling, _embeds, towers, unguided  # noqa: F401  (fixtures)
from tests.test_torch_sd import port  # noqa: F401  (a fixture)


@pytest.mark.parametrize("cfg_batched", [True, False], ids=["cfg_batched", "cfg_sequential"])
@pytest.mark.parametrize("inv_every", [1, 2])
@pytest.mark.parametrize("sampler", ["dpmpp"])
@pytest.mark.parametrize("embed", ["toy", "clip"])
def test_sample_with_inversion_matches_jax(rng, port, towers, unguided, embed, sampler, inv_every, cfg_batched):
    """Three guided CFG steps over (2, 32, 32, 4) latents; the target is a
    second embedding, so the loss is not at its minimum."""
    _check_guided_sampling(rng, port, _embeds(embed, towers), sampler, inv_every, cfg_batched, unguided=unguided)
