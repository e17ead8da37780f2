"""The traffic generators: deterministic in the seed, every seed the same
sizes in another order, every text exactly its size in tokens."""

import numpy as np
import pytest

from perfbench.harness import texts as tx
from perfbench.reference import frontend


def test_size_grid_is_a_fixed_multiset():
    g = tx.size_grid(64, 70, 0.536, 6, 248)
    assert len(g) == 64 and g == sorted(g)
    assert g[0] >= 6 and g[-1] == 248 and 60 <= g[32] <= 80


@pytest.mark.parametrize("tokens", [6, 7, 19, 47, 70, 135, 248])
def test_sentence_has_exactly_its_tokens(tokens):
    rng = np.random.default_rng(1)
    for _ in range(20):
        assert len(frontend.tokens(tx.sentence(rng, tokens, tx.words()))) == tokens


def test_same_seed_same_texts_other_seed_same_sizes():
    def draw(seed):
        rng = np.random.default_rng(seed)
        sizes = tx.shuffled(rng, tx.size_grid(64, 70, 0.536, 6, 248))
        return [tx.sentence(rng, n, tx.words()) for n in sizes]

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    assert a == b and a != c
    assert sorted(len(frontend.tokens(t)) for t in a) == sorted(len(frontend.tokens(t)) for t in c)


def test_program_front_end_agrees_with_the_reference():
    from viettts_tpu_torch.text import normalize_text, text_to_tokens

    rng = np.random.default_rng(3)
    for n in (6, 40, 135, 248):
        t = tx.sentence(rng, n, tx.words())
        para = t + " " + tx.sentence(rng, 30, tx.words())
        for text in (t, para, "Xin chào, các bạn!  Hôm nay: trời đẹp."):
            assert frontend.tokens(text) == text_to_tokens(normalize_text(text))
