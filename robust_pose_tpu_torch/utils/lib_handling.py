"""numpy / torch dispatch (the reference's own pairing; the JAX package's
copy pairs numpy with jax)."""
from __future__ import annotations

from functools import partial
from typing import Union

import numpy
import torch


def get_lib(data_object: Union[numpy.ndarray, torch.Tensor]):
    """The array module (numpy or torch) of the input."""
    if isinstance(data_object, numpy.ndarray):
        return numpy
    if isinstance(data_object, torch.Tensor):
        return torch
    raise TypeError("%s is not supported" % type(data_object))


def get_class(data_object: Union[numpy.ndarray, torch.Tensor]):
    """An array constructor of the input's library, and for a tensor of its
    dtype and device."""
    if isinstance(data_object, numpy.ndarray):
        return numpy.array
    if isinstance(data_object, torch.Tensor):
        return partial(torch.as_tensor, dtype=data_object.dtype,
                       device=data_object.device)
    raise TypeError("%s is not supported" % type(data_object))
