"""The NMS kernels' algorithm on the CPU (`csrc/nms3d.cu`).

The kernels replace `_greedy_nms`'s loop over an (M, M) IoU matrix by a
bit-packed suppression mask and a walk of the picks over order-preserving
score keys.  A numpy model of that walk, key for key and bit for bit,
stands here against `_greedy_nms` on the cases where the two could part:
ties, signed zeros, invalid rows, -inf and NaN scores, classes, fewer and
more picks than boxes kept, and M around a multiple of 64.  The kernels
themselves run only on the card (`tests/test_torch_port_cuda.py`); on
CPU tensors the wrappers stay on the plain path, which these tests also
check.
"""

import types

import numpy as np
import pytest
import torch

from mvsdet_torch.ops import nms

INACTIVE = np.uint64(0x007FFFFF)        # the key of -inf
NAN_KEY = np.uint64(0xFFFFFFFF)


def score_keys(scores: np.ndarray) -> np.ndarray:
    """The kernel's `score_key`: order-preserving uint32 keys of float32
    scores, -0 as +0, a NaN above every number."""
    v = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    keys = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(scores), NAN_KEY, keys).astype(np.uint64)


def packed_mask(suppress: np.ndarray) -> np.ndarray:
    """(M, M) bool -> (M, ceil(M / 64)) uint64, bit b of word w of row i
    being column 64 w + b, as `nms3d_mask_kernel` writes it."""
    m = suppress.shape[0]
    words = -(-m // 64)
    padded = np.zeros((m, words * 64), bool)
    padded[:, :m] = suppress
    bits = padded.reshape(m, words, 64).astype(np.uint64) \
        << np.arange(64, dtype=np.uint64)
    return np.bitwise_or.reduce(bits, axis=2)


def greedy_over_mask(mask: np.ndarray, scores: np.ndarray,
                     valid: np.ndarray, max_out: int):
    """`nms3d_greedy_kernel` in numpy: each pick the largest key and the
    lowest index that holds it (the largest key << 32 | ~index), a real
    one while its key is above -inf's and not a NaN's; the pick's mask row
    then makes the boxes it suppresses inactive."""
    m = scores.shape[0]
    cols = np.arange(m, dtype=np.uint64)
    key = np.where(valid, score_keys(scores), INACTIVE)
    keep_idx = np.zeros(max_out, np.int64)
    keep_mask = np.zeros(max_out, bool)
    for t in range(max_out):
        best = ((key << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - cols)).max()
        k = best >> np.uint64(32)
        if k <= INACTIVE or k == NAN_KEY:
            break
        i = int(np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF)))
        keep_idx[t], keep_mask[t] = i, True
        bits = (mask[i, cols // np.uint64(64)] >> (cols % np.uint64(64))) \
            & np.uint64(1)
        key = np.where(bits == 1, INACTIVE, key)
    return keep_idx, keep_mask


def random_boxes(rng, m: int, rotated: bool) -> np.ndarray:
    """m boxes crowded into a small room, so that many pairs overlap."""
    if rotated:
        return np.concatenate([
            rng.uniform(-1, 1, (m, 2)), rng.uniform(0, 0.5, (m, 1)),
            rng.uniform(0.3, 1.2, (m, 3)), rng.uniform(-np.pi, np.pi, (m, 1))],
            1).astype(np.float32)
    lo = rng.uniform(-1, 1, (m, 3))
    return np.concatenate([lo, lo + rng.uniform(0.3, 1.2, (m, 3))],
                          1).astype(np.float32)


def case(name: str, rng):
    """(m, scores, classes, valid, max_out) of one named edge."""
    m, max_out = 100, 100
    scores = rng.rand(m).astype(np.float32)
    classes = rng.randint(0, 3, m)
    valid = rng.rand(m) > 0.2
    if name == "score_ties":
        scores = np.round(scores * 4).astype(np.float32) / 4
    elif name == "all_scores_equal":
        scores[:] = 0.5
        valid[:] = True
    elif name == "signed_zero_ties":
        scores = np.where(rng.rand(m) < 0.5, -0.0, 0.0).astype(np.float32)
        valid[:] = True
    elif name == "valid_minus_inf":
        scores[::3] = -np.inf
    elif name == "no_valid_row":
        valid[:] = False
    elif name == "fewer_valid_than_max_out":
        valid[:] = False
        valid[rng.choice(m, 5, replace=False)] = True
    elif name == "one_class":
        classes[:] = 0
    elif name == "many_classes":
        classes = rng.randint(0, 17, m)
    elif name == "nan_score":
        scores[rng.choice(np.flatnonzero(valid), 2)] = np.nan
    elif name == "fewer_picks_than_kept":
        max_out = 20
    elif name == "more_picks_than_boxes":
        max_out = 2 * m
    elif name.startswith("m_"):
        m = int(name[2:])
        scores, classes = scores[:m], classes[:m]
        valid, max_out = valid[:m], m + 3
    return m, scores, classes, valid, max_out


CASES = ["score_ties", "all_scores_equal", "signed_zero_ties",
         "valid_minus_inf", "nan_score", "no_valid_row",
         "fewer_valid_than_max_out", "one_class", "many_classes",
         "fewer_picks_than_kept", "more_picks_than_boxes", "m_1", "m_63",
         "m_64", "m_65"]


@pytest.mark.parametrize("rotated", [False, True], ids=["aligned",
                                                         "rotated"])
@pytest.mark.parametrize("name", CASES)
def test_greedy_over_packed_mask_equals_greedy_nms(name, rotated):
    rng = np.random.RandomState(CASES.index(name))
    m, scores, classes, valid, max_out = case(name, rng)
    boxes = torch.from_numpy(random_boxes(rng, m, rotated))
    iou = (nms.rotated_iou_bev_exact if rotated else nms.aligned_iou_3d)(
        boxes, boxes)
    suppress = ((iou.numpy() > 0.25) & (classes[:, None] == classes[None])) \
        | np.eye(m, dtype=bool)
    got = greedy_over_mask(packed_mask(suppress), scores, valid, max_out)
    want = nms._greedy_nms(iou, torch.from_numpy(scores),
                           torch.from_numpy(classes), 0.25,
                           torch.from_numpy(valid), max_out)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0], want[0].numpy())


def test_score_keys_order_as_argmax_does():
    """Keys sort as the scores do; -0 ties +0; a NaN is above +inf."""
    s = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.25, np.inf,
                  np.nan], np.float32)
    k = score_keys(s)
    assert (np.diff(k[:3].astype(np.int64)) > 0).all()
    assert k[3] == k[4] and (np.diff(k[4:].astype(np.int64)) > 0).all()
    assert k[0] == INACTIVE and k[-1] == NAN_KEY


@pytest.mark.parametrize("rotated", [False, True], ids=["aligned",
                                                         "rotated"])
def test_cpu_tensors_stay_on_the_plain_path(rotated):
    rng = np.random.RandomState(7)
    m, scores, classes, valid, max_out = case("many_classes", rng)
    boxes = torch.from_numpy(random_boxes(rng, m, rotated))
    args = (torch.from_numpy(scores), torch.from_numpy(classes), 0.25,
            torch.from_numpy(valid), max_out)
    fn, iou = ((nms.rotated_3d_nms, nms.rotated_iou_bev_exact) if rotated
               else (nms.aligned_3d_nms, nms.aligned_iou_3d))
    launches = nms.nms3d.launches
    got = fn(boxes, *args)
    assert nms.nms3d.launches == launches
    want = nms._greedy_nms(iou(boxes, boxes), *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("device,dtype,kernel", [
    ("cuda", torch.float32, True), ("cuda", torch.bfloat16, True),
    ("cuda", torch.float64, True), ("cuda", torch.float16, True),
    ("cpu", torch.float32, False), ("cpu", torch.bfloat16, False)],
    ids=["cuda-float32", "cuda-bfloat16", "cuda-float64", "cuda-float16",
         "cpu-float32", "cpu-bfloat16"])
def test_kernels_take_the_boxes_on_the_card(device, dtype, kernel):
    """The kernels take every box on the card, whatever its dtype (the IoU
    computed as the plain version computes it in that dtype); the CPU
    keeps the plain version."""
    boxes = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert nms._on_card(boxes) is kernel


@pytest.mark.parametrize("shape,rotated,why", [
    ((10, 7), False, "must be"), ((10, 6), True, "must be"),
    ((10,), True, "must be"), ((10, 7), True, "boxes on a CUDA device")],
    ids=["aligned-width", "rotated-width", "flat", "cpu"])
def test_kernel_entries_refuse_what_they_do_not_take(shape, rotated, why):
    """Checked before anything is built: the boxes' width for the IoU,
    then their device (CPU tensors here)."""
    boxes = torch.zeros(shape)
    with pytest.raises(ValueError, match=why):
        nms.nms3d_mask(boxes, torch.zeros(shape[0], dtype=torch.int64), 0.25,
                       rotated)
    with pytest.raises(ValueError, match=why):
        nms.nms3d_iou(boxes, rotated)


@pytest.mark.parametrize("rotated", [False, True], ids=["aligned",
                                                         "rotated"])
def test_references_are_the_cpu_path(rotated):
    """`*_3d_nms_reference`, which the card's checks hold the kernels to,
    is what the wrappers run on the CPU."""
    rng = np.random.RandomState(11)
    m, scores, classes, valid, max_out = case("score_ties", rng)
    boxes = torch.from_numpy(random_boxes(rng, m, rotated))
    args = (boxes, torch.from_numpy(scores), torch.from_numpy(classes), 0.25,
            torch.from_numpy(valid), max_out)
    fn, ref = ((nms.rotated_3d_nms, nms.rotated_3d_nms_reference) if rotated
               else (nms.aligned_3d_nms, nms.aligned_3d_nms_reference))
    got, want = fn(*args), ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
