"""Weight conversion: reference torch / Paddle checkpoints -> the port's
flax-layout trees (the counterpart of pdf_table_tpu/convert/).

The ``*_convert.py`` name maps, ``torch_to_flax.py``, ``onnx_reader.py``
and ``hub.py`` are numpy copies of JAX's: each map fills a template tree
(the port's seeded init, engine/params.py::init_*) in the flax layout,
which is the port's checkpoint layout (engine/params.py, ``tree.pt``) and
which ``flax_bridge.py::load_flax_variables`` loads into the port's
modules. ``onnx_shape_matcher.py`` orders the ONNX route's slots by the
port's own module calls. ``python -m pdf_table_tpu_torch.convert`` is the
entry point.
"""

from .torch_to_flax import (ConversionReport, TorchTensorSource, convert_bn,
                            convert_conv, convert_dense)

__all__ = ["convert_conv", "convert_bn", "convert_dense",
           "ConversionReport", "TorchTensorSource"]
