"""The port's host sampler chain (runtime/sampling.py) and on-device sampling
(runtime/device_sampling.py) against the JAX package's.

Host chains: every make_chain configuration (greedy, top-k/top-p/min-p,
typical, mirostat 1 and 2, penalties, logit bias) and a DRY chain draw the
same token sequence as the JAX chain over 50 steps of logits drawn from a
seed with numpy: both run the same numpy arithmetic on the same inputs, so
the tokens must be equal, no tolerance.

sample_logits: greedy equals argmax (exactly).  The draw uses another
generator than JAX's (torch.Generator against jax.random), so the two are
compared as distributions: on a vocabulary of 32 with ties at the k-th
value and a top-p crossing, the set of tokens the port ever draws in 4000
draws equals the set JAX draws in 4000, and the port's frequencies pass a
chi-square test against the softmax over that set (p > 1e-3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.runtime import sampling as JS
from ggml_hexagon_tpu.runtime.device_sampling import (
    DeviceSamplerParams as JParams, sample_logits as j_sample)
from ggml_hexagon_tpu_torch.runtime import sampling as PS
from ggml_hexagon_tpu_torch.runtime.device_sampling import (
    DeviceSamplerParams, filter_logits, sample_logits)

V = 64
STEPS = 50

#: make_chain keyword sets: each configuration of the reference's order
CHAINS = {
    "greedy": dict(temp=0.0),
    "topk_topp_minp": dict(temp=0.8, top_k=20, top_p=0.9, min_p=0.05),
    "typical": dict(temp=0.7, top_k=0, top_p=1.0, min_p=0.0, typical_p=0.8),
    "mirostat1": dict(temp=0.9, mirostat=1, n_vocab=V),
    "mirostat2": dict(temp=0.9, mirostat=2, mirostat_tau=4.0),
    "penalties": dict(temp=0.8, penalty_last_n=16, penalty_repeat=1.3,
                      penalty_freq=0.2, penalty_present=0.4),
    "logit_bias": dict(temp=0.6, logit_bias={3: 5.0, 7: -1e9, 11: 2.5}),
}


def _logits(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=V) * 3.0).astype(np.float32)
            for _ in range(STEPS)]


@pytest.mark.parametrize("name", list(CHAINS))
def test_make_chain_draws_the_jax_tokens(name):
    kw = CHAINS[name]
    a, b = JS.make_chain(seed=5, **kw), PS.make_chain(seed=5, **kw)
    got = [b.sample(lg.copy()) for lg in _logits(1)]
    want = [a.sample(lg.copy()) for lg in _logits(1)]
    assert got == want
    assert len(set(want)) > (1 if name == "greedy" else 3)


def test_dry_chain_draws_the_jax_tokens():
    """DRY over a context that repeats, then a seeded draw."""
    def chain(m):
        return m.SamplerChain([m.DRY(multiplier=0.8, base=1.75,
                                     allowed_length=2, penalty_last_n=64),
                               m.Temp(0.9), m.Dist(3)])

    a, b = chain(JS), chain(PS)
    for s in (a, b):
        for t in [1, 2, 3, 4, 1, 2, 3]:  # a repeat DRY penalizes extending
            s.accept(t)
    got = [b.sample(lg.copy()) for lg in _logits(2)]
    want = [a.sample(lg.copy()) for lg in _logits(2)]
    assert got == want


def test_greedy_chain_is_argmax():
    lg = _logits(3)[0]
    assert PS.greedy_chain().sample(lg) == int(np.argmax(lg))


def test_sample_logits_greedy_is_argmax():
    rng = np.random.default_rng(4)
    lg = rng.normal(size=(3, 1000)).astype(np.float32)
    lg[1, 10] = lg[1, 20] = lg[1].max() + 1  # a tie: the first max
    got = sample_logits(torch.from_numpy(lg), None, DeviceSamplerParams())
    want = np.asarray(j_sample(jnp.asarray(lg), None, JParams()))
    assert got.tolist() == want.tolist() == np.argmax(lg, axis=1).tolist()


#: 32 logits: the top-k cut at k = 8 lands inside a tie (the 7th-10th
#: largest equal), so top-k keeps 10; top-p then keeps the tokens up to and
#: including the one whose cumulative probability crosses 0.9
_TIE_LOGITS = np.array([3.0, 2.6, 2.2, 2.0, 1.8, 1.6] + [1.2] * 4
                       + list(np.linspace(1.0, -2.0, 22)), np.float32)
_PARAMS = dict(temp=0.9, top_k=8, top_p=0.9, min_p=0.0)


def test_filter_keeps_the_ties_and_the_crossing_token():
    got = filter_logits(torch.from_numpy(_TIE_LOGITS)[None],
                        DeviceSamplerParams(**_PARAMS))[0]
    kept = set(np.flatnonzero(np.isfinite(got.numpy())).tolist())
    # the softmax over the 10 top-k survivors: cumulative 0.9 is crossed by
    # a token of the tie, which top-p keeps with every tie of its value
    l10 = _TIE_LOGITS[:10].astype(np.float64)
    p = np.exp(l10 - l10.max()) / np.exp(l10 - l10.max()).sum()
    cross = int(np.argmax(np.cumsum(p) >= 0.9))
    want = {i for i in range(10) if _TIE_LOGITS[i] >= _TIE_LOGITS[cross]}
    assert kept == want and len(want) >= 7


def test_sample_logits_draws_jax_set_and_softmax():
    n = 4000
    lg = np.tile(_TIE_LOGITS, (n, 1))
    gen = torch.Generator()
    gen.manual_seed(11)
    got = sample_logits(torch.from_numpy(lg), gen,
                        DeviceSamplerParams(**_PARAMS)).numpy()
    want = np.asarray(j_sample(jnp.asarray(lg), jax.random.PRNGKey(11),
                               JParams(**_PARAMS)))
    assert set(got.tolist()) == set(want.tolist())
    kept = sorted(set(got.tolist()))
    lk = _TIE_LOGITS[kept].astype(np.float64) / _PARAMS["temp"]
    p = np.exp(lk - lk.max())
    p /= p.sum()
    counts = np.array([(got == t).sum() for t in kept], np.float64)
    expect = p * n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    dof = len(kept) - 1
    # upper tail of chi-square with dof degrees of freedom (dof even: the
    # closed form), Wilson-Hilferty otherwise
    if dof % 2 == 0:
        x = chi2 / 2
        tail = math.exp(-x) * sum(x ** i / math.factorial(i)
                                  for i in range(dof // 2))
    else:
        z = ((chi2 / dof) ** (1 / 3) - (1 - 2 / (9 * dof))) / math.sqrt(
            2 / (9 * dof))
        tail = 0.5 * math.erfc(z / math.sqrt(2))
    assert tail > 1e-3, (chi2, dof, counts.tolist(), expect.tolist())
