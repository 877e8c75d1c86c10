"""Predict closure over host batches (port of `make_predict_fn`,
mvsdet_tpu/evaluation/harness.py:33-50).  The metric harness comes later.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from mvsdet_torch.models.mvsdet import MVSDet


def make_predict_fn(model: MVSDet, device="cuda"
                    ) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """fn(host numpy batch) -> host numpy prediction dict.

    The model is moved to ``device``, which is the card unless the caller
    asks for the CPU (raises when CUDA is missing).  Each batch is copied
    there, predicted under `torch.inference_mode`, and the outputs (boxes,
    scores, labels, mask, rendered, depth_expect) are copied back, which
    waits for the device.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    model.to(device)

    def predict(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        tensors = {k: torch.as_tensor(v).to(device, non_blocking=True)
                   for k, v in batch.items()}
        with torch.inference_mode():
            out = model.predict(tensors)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return predict
