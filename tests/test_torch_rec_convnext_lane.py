"""ConvNextViT's recognition lane without the 0/180 classifier, held to the
JAX package's fused device lane (``BatchPipeline._recognize_all_device``)
as tests/test_torch_rec_backbones.py holds the other lanes: the same tree,
canvases and quads, the packed ids and keep masks equal, confidences
within 1e-5, texts equal. In a file of its own because its JAX program
(some 13 s to compile) would take that file past a minute on one
worker."""

import torch

from test_torch_rec_backbones import test_lane_matches_jax as lane_matches

torch.set_num_threads(1)


def test_convnext_lane_without_the_classifier_matches_jax():
    lane_matches("ConvNextViT", False, None)
