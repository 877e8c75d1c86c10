"""The control on the card: the reference in the program's place,
computed with TF32 on (the precision below the configuration's float32
with TF32 off), must come out not correct by each cell's limits, at the
cell's own size.  It needs the card; the benchmark's own runs never run
it.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_control.py -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, check

CELLS = ["scannet_train", "arkit_predict", "scannet_predict"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control is read at the cell's size on a CUDA card")
    c = cells.find_cell(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (424242, 2**31 + 5):
        numbers = cells.load_mode(c).control(c, seed)["numbers"]
        assert not check.verdict(numbers, c.limits), numbers
