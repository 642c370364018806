"""The inputs of a run, drawn from ``--seed``: the same seed gives the same
inputs.  Both sides get them: the program its problem's numbers, the
reference the raw draws (the ensemble's samples) from which it builds its
own, and the guesses.  What the draws are is the configuration kind's
(``programs/<kind>.py`` ``draw`` and ``guess``); which of them a run
takes, and in which order, is decided here.

Every seed gets the same work in another order: the guesses are a pool of
``traffic["guess"]["pool"]``, the same for every seed, and the seed draws
the order in which the window's solves take them.  The warm-up takes a
guess of its own, outside the pool."""

import numpy as np

__all__ = ["rng", "draw", "guess", "warmup_guess"]

POOL_STREAM, WARMUP_STREAM = 2, 4


def rng(seed, *stream):
    """The generator of ``stream`` under ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def _kind(config):
    from benchmark import programs

    return programs.load(config["kind"])


def draw(config, seed):
    """The raw inputs shared by the program and the reference."""
    return _kind(config).draw(config, seed)


def guess(config, traffic, seed, index):
    """The guess of the window's solve ``index`` under ``seed``: member
    ``order[index % pool]`` of the pool, ``order`` a permutation drawn from
    the seed."""
    pool = int(traffic["guess"]["pool"])
    order = rng(seed, 3).permutation(pool)
    return _kind(config).guess(config, traffic,
                               rng(0, POOL_STREAM, int(order[index % pool])))


def warmup_guess(config, traffic, seed):
    """The set-up's guess: drawn like the pool's, from the seed."""
    return _kind(config).guess(config, traffic, rng(seed, WARMUP_STREAM))
