"""Object-detection layers (port of
``deeplearning4j_tpu/nn/conf/layers_objdetect.py``;
``org.deeplearning4j.nn.conf.layers.objdetect.Yolo2OutputLayer``).

Lives under nn/conf so the layer registry knows it: a TinyYOLO
checkpoint restores in any process without importing the zoo first.
"""
from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_torch.nn.conf.base import register_layer
from deeplearning4j_torch.nn.conf.layers_core import BaseOutputLayerConf


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(BaseOutputLayerConf):
    """Detection loss head over a [b, gh, gw, 5 + n_classes] feature map.

    lambda_coord / lambda_noobj follow the YOLO paper defaults DL4J
    exposes.  Predictions: sigmoid on objectness + cx/cy, raw w/h,
    softmax over classes.  The loss's arithmetic runs in the reference's
    order, term for term.
    """

    n_classes: int = 20
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        want = 5 + self.n_classes
        if int(c) != want:
            raise ValueError(
                f"Yolo2OutputLayer needs {want} input channels "
                f"(5 + n_classes), got {c}")
        return input_shape

    def pre_output(self, params, x, compute_dtype=None):
        return x

    def per_example_score(self, labels, z, mask=None, head_input=None,
                          rng=None, params=None):
        z = self.promote_head(z)
        labels = self.promote_head(labels)
        obj_logit = z[..., 0]
        xy = torch.sigmoid(z[..., 1:3])
        wh = z[..., 3:5]
        cls_logits = z[..., 5:]
        t_obj = labels[..., 0]
        t_xy = labels[..., 1:3]
        t_wh = labels[..., 3:5]
        t_cls = labels[..., 5:]

        coord = torch.sum(torch.square(xy - t_xy), -1) + \
            torch.sum(torch.square(wh - t_wh), -1)
        obj_p = torch.sigmoid(obj_logit)
        conf_obj = torch.square(1.0 - obj_p)
        conf_noobj = torch.square(obj_p)
        cls_ce = -torch.sum(t_cls * torch.log_softmax(cls_logits, -1), -1)
        per_cell = (t_obj * (self.lambda_coord * coord + conf_obj + cls_ce)
                    + (1.0 - t_obj) * self.lambda_noobj * conf_noobj)
        score = torch.sum(per_cell, dim=(1, 2))
        if mask is not None:
            score = score * mask.reshape(score.shape[0])
        return score

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        x = self.promote_head(x)
        return torch.cat([torch.sigmoid(x[..., :1]),
                          torch.sigmoid(x[..., 1:3]), x[..., 3:5],
                          torch.softmax(x[..., 5:], -1)], dim=-1)
