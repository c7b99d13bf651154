"""The traffic generator: the same seed gives the same objects, other
seeds others, and every seed the mix's count and sizes."""

import numpy as np
import pytest

from portbench import run
from portbench.traffic import generate

SEEDS = (0, 7, 2**31 + 12345, 3 * 2**31 - 1)


def mix(name, **over):
    return {**run.load_json(run.HERE, "traffic", f"{name}.json"), **over}


@pytest.mark.parametrize("seed", SEEDS)
def test_pg_x6_sizes_and_period(seed):
    objs = generate.objects(mix("pg-x6"), seed, run.ROOT)
    assert len(objs) == 4
    raw = open(f"{run.HERE}/data/pg1661.txt", "rb").read()
    for o in objs:
        assert o.dtype == np.uint8 and o.shape == (3_569_598,)
        assert np.array_equal(o[:594_933], o[594_933: 2 * 594_933])
        # a rotation of the book
        assert o[:594_933].tobytes() in raw * 2


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_objects(seed):
    m = mix("words-25m", size=200_000)
    a = generate.objects(m, seed, run.ROOT)
    b = generate.objects(m, seed, run.ROOT)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = generate.objects(m, seed + 1, run.ROOT)
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


def test_words_at_its_size():
    m = mix("words-25m")
    objs = generate.objects(m, 2**31 + 99, run.ROOT)
    assert len(objs) == 2
    book = set(generate.TOKEN.findall(open(f"{run.HERE}/data/pg1661.txt",
                                           "rb").read()))
    for o in objs:
        assert o.dtype == np.uint8 and o.shape == (26_214_400,)
        # every token but the last (cut to size) is one of the book's
        assert set(generate.TOKEN.findall(o.tobytes())[:-1]) <= book
    assert not np.array_equal(objs[0], objs[1])


def test_words_drawn_by_frequency():
    m = mix("words-25m", size=2_000_000, objects=1)
    (o,) = generate.objects(m, 5, run.ROOT)
    text = o.tobytes()
    book = open(f"{run.HERE}/data/pg1661.txt", "rb").read()
    drawn = generate.TOKEN.findall(text)
    for w in (b"the ", b"and ", b"Holmes "):
        share = drawn.count(w) / len(drawn)
        want = generate.TOKEN.findall(book).count(w) / len(
            generate.TOKEN.findall(book))
        assert abs(share - want) < 0.15 * want
    # no long period: LZP's 32-byte matches are rare
    assert len(set(text[i: i + 32] for i in range(0, 200_000, 7))) > 0.99 * (
        200_000 // 7 + 1)
