"""`lax_topk` on the rows that raised while it narrowed long rows to
their top-k 128-wide windows (``k * 128`` or ``n / 128`` above K13's row
limit ``max_n``).

Past ``max_n`` a row now goes through chunks of ``max_n`` values (K13's
top-k of each, the candidates in catalog order, again until one call
takes the rest), and a row whose k is at or above the chunk size through
a stable sort of the total-order keys. Each is held at a small ``max_n``
to ``jax.lax.top_k``: values bit for bit, ids equal, on ties that span
chunks, +0.0 beside -0.0, NaN of either sign and -inf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sibrar_tpu_torch.ops.topk import lax_topk


def _row_mix(rng, shape):
    """Integer values 0-3 (every value tied many times over, across
    chunks), a share of +0.0 / -0.0, NaN of both signs and -inf."""
    x = rng.integers(0, 4, shape).astype(np.float32)
    u = rng.random(shape)
    x[u < 0.2] = 0.0
    x[(u >= 0.2) & (u < 0.4)] = -0.0
    x[(u >= 0.4) & (u < 0.402)] = np.nan
    x[(u >= 0.402) & (u < 0.404)] = -np.inf
    bits = x.view(np.int32)
    bits[(u >= 0.404) & (u < 0.406)] = -1  # the all-ones NaN, sign set
    return x


# (n, k, max_n): k * 128 > max_n (one round and several rounds of
# chunks), n / 128 > max_n, k at and above the chunk size, k = n
CASES = {
    "k_times_128_over_max_n": (5_000, 9, 1024),
    "several_rounds": (20_000, 100, 1024),
    "n_over_128_max_n": (10_000, 3, 64),
    "short_last_chunk": (2_050, 40, 1024),
    "k_equals_chunk": (3_000, 512, 512),
    "k_above_chunk": (3_000, 600, 512),
    "k_equals_n": (1_500, 1_500, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lax_topk_past_the_window_limits_equals_lax(case):
    n, k, max_n = CASES[case]
    x = _row_mix(np.random.default_rng(n + k), (3, n))
    v, i = lax_topk(torch.as_tensor(x), k, max_n)
    wv, wi = lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))


def test_lax_topk_chunks_keep_the_lower_index_on_ties():
    """One value everywhere: each chunk's candidates are its first k ids,
    and the answer the row's first k, as ``lax.top_k`` gives them."""
    x = np.full((2, 4_100), 7.0, np.float32)
    v, i = lax_topk(torch.as_tensor(x), 20, 1024)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(20), (2, 1)))
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(lax.top_k(jnp.asarray(x), 20)[1]))


@pytest.mark.parametrize("k", [9, 600])
def test_lax_topk_past_the_limits_keeps_half_dtypes(k):
    """bf16 rows rank as f32 and come back as bf16 on the chunk and the
    sort paths."""
    x = _row_mix(np.random.default_rng(k), (2, 3_000))
    xb = torch.as_tensor(x).to(torch.bfloat16)
    v, i = lax_topk(xb, k, 512)
    assert v.dtype == torch.bfloat16
    wv, wi = lax.top_k(jnp.asarray(xb.float().numpy()), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.float().numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))
