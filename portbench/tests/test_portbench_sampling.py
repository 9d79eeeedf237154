"""``sample_z`` on made-up distributions: tokens drawn from the tempered
distribution read like the absolute value of a standard normal; a draw at
another temperature, a greedy pick or an altered token reads far above
the cells' limit."""
import pytest
import torch

from portbench.control import _gumbel_pick
from portbench.serve import places, z_of

V, N, T = 4096, 800, 0.8


def _readings(pick):
    gen = torch.Generator().manual_seed(2 ** 31 + 3)
    logits = torch.randn(N, V, generator=gen)
    tok = pick(logits, gen)
    return z_of(places(logits, tok, T, gen).tolist())


def test_draws_from_the_tempered_distribution_read_small():
    z = _readings(lambda lg, gen: _gumbel_pick(lg, T, gen))
    assert z < 3.0


@pytest.mark.parametrize("pick", [
    lambda lg, gen: _gumbel_pick(lg, 1.0, gen),
    lambda lg, gen: lg.argmax(-1),
    lambda lg, gen: (_gumbel_pick(lg, T, gen) + 1) % V],
    ids=["temperature_1", "greedy", "altered"])
def test_wrong_draws_read_large(pick):
    assert _readings(pick) > 4.5


def test_no_tokens_reads_infinite():
    assert z_of([]) == float("inf")
