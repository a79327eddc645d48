"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (`paddle_tpu`) is the reference; this package re-implements
it on PyTorch for an NVIDIA Hopper GPU, one slice at a time. Module names
follow the JAX package so each counterpart is easy to find:

  * `models.gpt`            GPT configs; the contiguous and paged decode
                            forwards; the training `GPT`; weights
                            carried from JAX
  * `framework`             `save` / `load` (the JAX package's pickle
                            format), `ParamAttr`, `param_arrays` /
                            `state_arrays`: a layer's tensors as the flat
                            dicts the decode fns take
  * `memory.page_allocator` refcounted KV page bookkeeping + pool ops
  * `core`                  `Tensor` (a torch.Tensor subclass, see
                            `core.tensor`), `to_tensor`, autograd
                            (`grad`, `no_grad`), dtypes, places,
                            `set_device` / `get_device`, seeds
  * `ops`                   the tensor function library (creation,
                            math, manipulation, linalg, logic, search,
                            stat, random, `einsum`), also at the top
                            level and as `Tensor` methods
  * `ops.kernels`           hand-written CUDA kernels and their plain
                            PyTorch versions (`decode_attention`,
                            `quant_matmul`, `flash_attention`,
                            `fused_ce`)
  * `quant`                 int8 PTQ of decode weights, int8 KV pages
  * `inference.decode`      the paged-KV continuous-batching DecodeEngine
  * `inference.serve`       the PDI1/PDI2 decode server
  * `observability`, `profiler`, `core.monitor`
                            the metrics registry and admin plane, request
                            spans, tracez, profilez, memz, varz / SLO, the
                            stall flight recorder; RecordEvent tables and
                            torch.profiler device traces; stat counters and
                            per-card memory
  * `nn`, `amp`, `optimizer`, `io`, `static`, `distributed.fleet`, `hapi`
                            the training slice: layers and functionals,
                            gradient clips, op-by-op AMP with dynamic
                            loss scaling (`GradScaler`, `decorate`), SGD /
                            Momentum / Adam / AdamW / Lamb / Lars /
                            RMSProp / Adagrad / Adadelta / Adamax with LR
                            schedulers,
                            datasets, samplers, the worker DataLoader
                            and `device_prefetch`, the strategy and its
                            single-device train step, `Model.fit` /
                            `evaluate` / `predict` / `save` / `load`,
                            `summary` / `flops`, the callbacks
  * `metric`, `regularizer` Accuracy / Precision / Recall / Auc; L1Decay /
                            L2Decay
  * `io.checkpoint`         format-2 checkpoint directories (atomic,
                            checksummed), one process; `io.crypto`
                            encrypted model files (`save` / `load`
                            with `cipher_key`)
  * `vision`                LeNet and ResNet (`vision.models`), the
                            numpy transforms, the local-file datasets
                            and folders, image loading

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or calls ``set_device("cpu")``); without a GPU they raise instead of
carrying on on the CPU. This package imports neither `jax` nor
`paddle_tpu`.
"""

from . import (amp, distributed, framework, hapi, io, metric, models, nn,
               optimizer, regularizer, static)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.errors import enforce
from .core.flags import get_flags, set_flags
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPinnedPlace,
                         TPUPlace, XPUPlace, device_count, get_device,
                         is_compiled_with_cuda, is_compiled_with_tpu,
                         set_device)
from .core.random import (get_cuda_rng_state, get_rng_state, seed,
                          set_cuda_rng_state, set_rng_state)
from .core.tensor import (Parameter, Tensor, enable_grad, no_grad,
                          set_grad_enabled, to_tensor)
from .core.autograd import grad

from .ops import *  # noqa: F401,F403  (the tensor function library)
from .ops import einsum  # noqa: F401

from .distributed.parallel import DataParallel  # noqa: F401
from .framework import ParamAttr, load, save
from .hapi import Model, callbacks, flops, summary
from . import device, inference, observability, quant, utils  # noqa: F401
from . import profiler  # noqa: F401
from .core import monitor  # noqa: F401
from . import tensor  # noqa: F401,E402  (the paddle.tensor alias module)

# LoD-era type aliases, as in the JAX package: a LoDTensor and a VarBase
# are the eager Tensor, a LoDTensorArray a list
LoDTensor = Tensor
VarBase = Tensor
LoDTensorArray = list


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batched reader: `reader` is a zero-arg
    generator function; the result yields lists of `batch_size`
    samples."""
    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader


__version__ = "0.1.0"
full_version = __version__
commit = "cuda-port"
