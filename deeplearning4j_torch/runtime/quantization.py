"""Post-training weight quantization for inference (port of
``deeplearning4j_tpu/runtime/quantization.py``).

WEIGHT-ONLY symmetric int8 with per-output-channel scales.  The int8
leaves and their f32 scales stay on the model's device, and every call
dequantizes them (``int8 -> compute dtype * scale``, in the compute
dtype) before the model's inference forward, as the reference does
inside its jitted forward; activations stay in the compute dtype.
Eligible leaves: floating-point kernels with >= 2 dims (dense ``W``,
conv HWIO, attention projections); vectors (biases, norm gains) stay
as they are.  ``quantize_leaf`` is the reference's numpy code, so the
int8 values and scales are bit-equal to its.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_torch.runtime.dtype import canonical_dtype
from deeplearning4j_torch.utils.trees import iter_leaves, set_path


def _eligible(a) -> bool:
    a = np.asarray(a)
    return a.ndim >= 2 and np.issubdtype(a.dtype, np.floating)


def quantize_leaf(a) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: scale over all axes except
    the LAST (the output-channel axis of Dense [in, out] and conv HWIO
    kernels).  Returns (int8 array, f32 scale[last_dim])."""
    a = np.asarray(a, np.float32)
    red = tuple(range(a.ndim - 1))
    amax = np.maximum(np.abs(a).max(axis=red), 1e-12)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale


def _host_array(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class QuantizedInference:
    """Weight-only int8 inference wrapper for a MultiLayerNetwork or
    ComputationGraph.

    >>> qi = QuantizedInference(model)
    >>> y = qi.output(x)   # int8 weights dequantized to bf16, math in
    ...                    # the model's compute dtype
    >>> qi.compression_ratio()            # ~3.9x on conv/dense models
    """

    def __init__(self, model, compute_dtype=torch.bfloat16):
        model._check_init()
        self.model = model
        self.compute_dtype = canonical_dtype(compute_dtype)
        dev = model.device
        self._quant: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._plain: Dict[tuple, torch.Tensor] = {}
        self._orig_bytes = 0
        self._new_bytes = 0
        for path, leaf in iter_leaves(model.params_tree):
            arr = _host_array(leaf)
            self._orig_bytes += arr.nbytes
            if _eligible(arr):
                q, s = quantize_leaf(arr)
                self._quant[path] = (torch.from_numpy(q).to(dev),
                                     torch.from_numpy(s).to(dev))
                self._new_bytes += q.nbytes + s.nbytes
            else:
                self._plain[path] = leaf.detach()
                self._new_bytes += arr.nbytes
        # the tree's skeleton: a layer without parameters keeps its
        # empty dict
        self._keys = list(model.params_tree)

    def _dequant(self, q, s):
        cd = self.compute_dtype
        return q.to(cd) * s.to(cd)

    def _params(self):
        tree = {key: {} for key in self._keys}
        for path, (q, s) in self._quant.items():
            set_path(tree, path, self._dequant(q, s))
        for path, a in self._plain.items():
            set_path(tree, path, a)
        return tree

    @torch.no_grad()
    def output(self, x):
        """Inference forward with weights dequantized on every call.
        Returns what ``model.output`` would: a tensor on the model's
        device, or a list in ``network_outputs`` order for a multi-output
        graph.  Multi-input graphs take a list/dict of arrays."""
        out = self.model._forward_infer(self._params(),
                                        self.model.state_tree, x)
        if isinstance(out, dict):                 # ComputationGraph
            names = self.model.conf.network_outputs
            vals = [out[n] for n in names]
            return vals[0] if len(vals) == 1 else vals
        return out

    def compression_ratio(self) -> float:
        return self._orig_bytes / max(self._new_bytes, 1)

    def max_abs_weight_error(self) -> float:
        """Largest |w - dequant(q)| across quantized leaves, computed with
        the same compute-dtype dequantization the forward performs."""
        leaves = dict(iter_leaves(self.model.params_tree))
        err = 0.0
        for path, (q, s) in self._quant.items():
            deq = _host_array(self._dequant(q, s)).astype(np.float32)
            err = max(err, float(np.abs(
                _host_array(leaves[path]).astype(np.float32) - deq).max()))
        return err
