"""The port draws the JAX package's initial weights without JAX
(`mvsdet_torch/models/flax_init.py`).

- threefry's keys, `fold_in`, `split` and random bits are bit-equal to
  `jax.random`'s;
- `truncated_normal(-2, 2)`: at least 98% of the values bit-equal to
  `jax.random.truncated_normal`'s (measured: 99.1%; numpy's log1p rounds
  otherwise than XLA's now and then), every other one within 4 float32
  epsilons of it, relative (measured: 2);
- `create_train_state(flax_seed=s)` and `create_nerfdet_state(flax_seed=s)`
  (whose init key is the first of a split) hold, key for key, the variables
  JAX's `create_train_state` / `create_nerfdet_state` initialise from
  `PRNGKey(s)`: the constants equal, the kernels at least 98% bit-equal
  and within 4 epsilons elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvsdet_tpu.config import tiny_test_config as jx_tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.training import loop as jx_loop

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.interop import flax_to_state_dict
from mvsdet_torch.models import flax_init
from mvsdet_torch.training import loop

SEEDS = (0, 1, 123456)


def bit_equal_share_and_close(got, want):
    """(share bit-equal, whether every value is within 4 float32 epsilons
    of ``want``, relative)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    eps = np.finfo(np.float32).eps
    return (float(np.mean(got == want)),
            bool(np.all(np.abs(got - want) <= 4 * eps * np.abs(want))))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_are_jax_bits(seed):
    key = jax.random.PRNGKey(seed)
    ours = flax_init.prng_key(seed)
    assert tuple(np.asarray(key).tolist()) == ours
    for data in (0, 77, 0xDEADBEEF):
        assert tuple(np.asarray(jax.random.fold_in(key, data)).tolist()) \
            == flax_init.fold_in(ours, data)
    assert [tuple(k) for k in np.asarray(jax.random.split(key, 3)).tolist()] \
        == flax_init.split(ours, 3)
    for shape in ((7,), (3, 5), (2, 3, 4, 5)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(key, shape)),
            flax_init.random_bits(ours, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_truncated_normal_is_jax_up_to_rounding(seed):
    want = jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2,
                                       (1000, 37))
    got = flax_init.truncated_normal(flax_init.prng_key(seed), (1000, 37))
    share, close = bit_equal_share_and_close(got, want)
    assert share >= 0.98 and close, share


@pytest.mark.parametrize("family", ["mvsdet", "nerfdet"])
def test_state_holds_jax_initial_variables(family):
    seed = 1
    jx_cfg, cfg = jx_tiny_test_config(), tiny_test_config()
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_scene(
        jx_cfg, seed=0, n_views=3, n_targets=1).items()}
    if family == "nerfdet":
        _, jx_state, _ = jx_loop.create_nerfdet_state(
            jx_cfg, jax.random.PRNGKey(seed), batch, steps_per_epoch=1)
        state = loop.create_nerfdet_state(cfg, device="cpu",
                                          flax_seed=seed)
    else:
        _, jx_state, _ = jx_loop.create_train_state(
            jx_cfg, jax.random.PRNGKey(seed), batch, sweep_chunk=3,
            steps_per_epoch=1)
        state = loop.create_train_state(cfg, device="cpu", sweep_chunk=3,
                                        flax_seed=seed)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": jx_state.params, "batch_stats": jx_state.batch_stats,
        "frozen": jx_state.frozen}))
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    kernels = [k for k in want if k.endswith(".weight") and want[k].ndim > 1]
    assert len(kernels) > 50
    for key, value in want.items():
        if key in kernels:
            continue
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    equal = total = 0
    for key in kernels:
        share, close = bit_equal_share_and_close(got[key], want[key])
        assert close, key
        equal += share * want[key].size
        total += want[key].size
    assert equal / total >= 0.98, equal / total
