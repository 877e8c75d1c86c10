"""The lift backward's row index and plain versions on the CPU.

K4 and K5 (`csrc/weighted_gather_sum_bwd.cu`) walk one index of the
(view, voxel) pairs sorted by the feature row they touch.  Here its plain
version, `lift_rows_reference`, is checked for what the kernels rely on,
and the backward's plain versions (the one in K4's order among them) are
held against `jax.vjp` of the JAX kernel, whose Pallas backward kernels
run in interpret mode.  The kernels themselves are held against these
plain versions in `test_torch_port_cuda.py`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.ops.pallas.lift_kernel import \
    weighted_gather_sum as jx_weighted_gather_sum

from mvsdet_torch.ops.lift_kernel import (
    lift_rows, lift_rows_reference, weighted_gather_sum,
    weighted_gather_sum_dfeat, weighted_gather_sum_dfeat_reference,
    weighted_gather_sum_dfeat_rows_reference, weighted_gather_sum_dweight,
    weighted_gather_sum_dweight_reference)

from _lift_cases import lift_case


def rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def torch_case(kind, n, hw, c, v, seed=0):
    return tuple(map(torch.from_numpy, lift_case(kind, n, hw, c, v, seed)))


@pytest.mark.parametrize("kind,n,hw,v", [
    ("uniform", 3, 40, 300),
    ("sparse_rows", 2, 1000, 80),       # most rows hold no pair
    ("single_row", 2, 30, 500),         # one row of each view holds them all
    ("clipped", 4, 300, 900),           # 55% of the pairs on 1% of the rows
])
def test_index_lists_every_pair_in_row_order(kind, n, hw, v):
    _, pix, _, _ = torch_case(kind, n, hw, 4, v)
    row_start, pair = lift_rows(pix, hw)
    assert row_start.dtype == pair.dtype == torch.int32
    assert row_start.shape == (n * hw + 1,) and pair.shape == (n * v,)
    p = pair.long()
    assert torch.equal(p.sort().values, torch.arange(n * v))
    key = p // v * hw + pix.flatten().long()[p]
    counts = torch.bincount(key, minlength=n * hw)
    assert row_start[0] == 0 and row_start[-1] == n * v
    assert torch.equal(row_start.diff().long(), counts)
    assert bool((key.diff() >= 0).all())                  # rows ascending
    same_row = key[1:] == key[:-1]
    assert bool((p.diff()[same_row] > 0).all())           # v ascending
    row = torch.repeat_interleave(torch.arange(n * hw), counts)
    assert torch.equal(row, key)                          # pairs in their row
    if kind == "sparse_rows":
        assert (counts == 0).float().mean() > 0.9
    if kind == "single_row":
        assert int(counts.max()) == v


@pytest.mark.parametrize("kind", ["uniform", "clipped", "zero_weight"])
def test_plain_backward_matches_jax_kernels(kind):
    """d-feat in either order (per view with index_add_, or per row in
    ascending v as K4 sums) and d-weight against the JAX `_vjp_bwd`."""
    n, hw, c, v = 3, 200, 8, 600
    feat, pix, weight, g = lift_case(kind, n, hw, c, v, seed=5)
    _, vjp = jax.vjp(lambda f, w: jx_weighted_gather_sum(
        f, jnp.asarray(pix), w), jnp.asarray(feat), jnp.asarray(weight))
    want_f, want_w = map(np.asarray, vjp(jnp.asarray(g)))
    t_pix, t_w, t_g = map(torch.from_numpy, (pix, weight, g))
    in_order = weighted_gather_sum_dfeat_rows_reference(
        lift_rows_reference(t_pix, hw), t_w, t_g, hw)
    per_view = weighted_gather_sum_dfeat_reference(t_pix, t_w, t_g, hw)
    dw = weighted_gather_sum_dweight_reference(torch.from_numpy(feat), t_pix,
                                               t_g)
    if kind == "zero_weight":
        assert not np.any(want_f) and not in_order.any() \
            and not per_view.any()
    else:
        assert rel_err(in_order.numpy(), want_f) <= 1e-5
        assert rel_err(per_view.numpy(), want_f) <= 1e-5
    assert rel_err(dw.numpy(), want_w) <= 1e-5
    # every pair has a d-weight, the zero-weight ones too
    assert np.abs(dw.numpy()[weight == 0]).min() > 0


def test_shared_index_gives_the_separate_calls_gradients():
    """The autograd Function's gradients equal the two wrappers called
    alone, with and without an index; on CPU tensors nothing launches."""
    feat, pix, weight, g = torch_case("clipped", 3, 300, 8, 700, seed=2)
    f = feat.clone().requires_grad_(True)
    w = weight.clone().requires_grad_(True)
    counted = (weighted_gather_sum, weighted_gather_sum_dfeat,
               weighted_gather_sum_dweight, lift_rows)
    before = [k.launches for k in counted]
    weighted_gather_sum(f, pix, w).backward(g)
    rows = lift_rows(pix, 300)
    for d in (weighted_gather_sum_dfeat(pix, weight, g, 300),
              weighted_gather_sum_dfeat(pix, weight, g, 300, rows)):
        assert torch.equal(f.grad, d)
    for d in (weighted_gather_sum_dweight(feat, pix, g),
              weighted_gather_sum_dweight(feat, pix, g, rows)):
        assert torch.equal(w.grad, d)
    assert [k.launches for k in counted] == before


@pytest.mark.parametrize("call", ["lift_rows", "dfeat", "dweight"])
def test_index_size_is_checked(call):
    """N*HW and N*V index int32 arrays; stride-0 views stand in for inputs
    too large to allocate."""
    pix = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        if call == "lift_rows":
            lift_rows(torch.zeros(1, 1, dtype=torch.int32).expand(2, 2**30),
                      4)
        elif call == "dfeat":
            weighted_gather_sum_dfeat(pix, torch.zeros(2, 5),
                                      torch.zeros(5, 8), 2**30)
        else:
            weighted_gather_sum_dweight(
                torch.zeros(1, 1, 8).expand(2, 2**30, 8), pix,
                torch.zeros(5, 8))


def test_an_index_of_other_inputs_is_refused():
    _, pix, weight, g = torch_case("uniform", 3, 40, 8, 30)
    rows = lift_rows(pix[:2], 40)
    with pytest.raises(ValueError, match="lift_rows"):
        weighted_gather_sum_dfeat(pix, weight, g, 40, rows)
    with pytest.raises(ValueError, match="lift_rows"):
        weighted_gather_sum_dweight(torch.zeros(3, 40, 8), pix, g,
                                    lift_rows(pix, 41))


@pytest.mark.parametrize("bad", [-1, 40])
def test_index_check_refuses_a_pix_outside_the_rows(bad):
    """With `check`, a pix outside [0, HW) raises before the index is
    built (the kernel would leave that pair out); without, nothing is
    read back."""
    _, pix, _, _ = torch_case("uniform", 2, 40, 4, 50)
    assert all(torch.equal(a, b) for a, b in zip(
        lift_rows(pix, 40, check=True), lift_rows(pix, 40)))
    pix[1, 7] = bad
    with pytest.raises(ValueError, match=r"\[0, 40\)"):
        lift_rows(pix, 40, check=True)


def test_row_load_count_is_refused_on_the_cpu():
    """Only K5 counts its feature-row loads; the plain version has none."""
    feat, pix, _, g = torch_case("uniform", 2, 40, 8, 30)
    with pytest.raises(ValueError, match="row_loads"):
        weighted_gather_sum_dweight(feat, pix, g, None,
                                    torch.zeros(1, dtype=torch.int32))
