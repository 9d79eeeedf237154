"""The general traffic generator: seeded, repeatable, the same sizes for
every seed."""
import collections
import statistics

from portbench.cell import manifest, resolve
from portbench.generator import RequestStream, stratified_lengths

MIXES = ["qwen2-7b.serve.conversation", "qwen2-7b.serve.docqa"]


def _draw(mix, seed, n):
    s = RequestStream(mix, 1000, seed)
    return [s.next() for _ in range(n)]


def test_same_seed_repeats():
    for name in MIXES:
        mix = resolve(name, manifest())["traffic"]
        assert _draw(mix, 2 ** 31 + 5, 40) == _draw(mix, 2 ** 31 + 5, 40)
        assert _draw(mix, 3, 40) != _draw(mix, 4, 40)


def test_every_seed_serves_the_same_sizes():
    for name in MIXES:
        mix = resolve(name, manifest())["traffic"]
        n = mix["pool"]
        sizes = []
        for seed in (1, 99, 2 ** 31 + 11):
            reqs = _draw(mix, seed, n)
            sizes.append((collections.Counter(len(p) for p, _, _ in reqs),
                          collections.Counter(o for _, o, _ in reqs)))
            assert [len(p) for p, _, _ in reqs] != [len(p) for p, _, _ in
                                                    _draw(mix, seed + 1, n)]
        assert sizes[0] == sizes[1] == sizes[2]


def test_lengths_and_temperatures():
    mix = resolve(MIXES[0], manifest())["traffic"]
    p = stratified_lengths(mix["prompt"], mix["pool"])
    assert p.min() >= 32 and p.max() <= 3584
    assert abs(statistics.median(p) - 1020) <= 4            # the median
    reqs = _draw(mix, 7, 16)
    temps = [t for _, _, t in reqs]
    assert temps == [0.8 if i % 4 == 3 else 0.0 for i in range(16)]
    assert all(0 <= tok < 1000 for p, _, _ in reqs for tok in p)
