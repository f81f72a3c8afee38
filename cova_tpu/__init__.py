"""cova_tpu — an accelerator-native compressed-domain video-analytics framework.

A from-scratch rebuild of the capabilities of CoVA ("Exploiting
Compressed-Domain Analysis to Accelerate Video Analytics", USENIX ATC'22,
reference implementation casys-kaist/CoVA) in JAX, run on one or more
NVIDIA H100 GPUs:

* the compressed-domain stage (macroblock metadata -> BlobNet mask) runs
  as one jitted, batched JAX program on the accelerator — frames are
  batch dimensions, streams/GoP-ranges are a vmapped/sharded axis;
  connected components + SORT run in native host code by default, or
  inside the program (tracker state a ``lax.scan`` carry);
* the codec host layer (MP4 demux, H.264 entropy decode, selective pixel
  decode) is C++ bound via ctypes;
* the pixel-domain oracle is a host stand-in detector (models/bgdet.py)
  or, with extra packages, the Flax YOLOv4 in models/yolov4.py, run
  over the few frames that survive compressed-domain filtering;
* aggregation/association and query metrics are in-process modules instead
  of the reference's TCP-connected processes.

Layer map (mirrors reference SURVEY.md §1, re-architected):

  L6 query       cova_tpu.query           (reference: parse/)
  L5 aggregate   cova_tpu.aggregator      (reference: cova-rs/analysis-aggregator)
  L4 orchestrate cova_tpu.pipeline        (reference: pipeline/, experiment/)
  L3 dataflow    cova_tpu.ops, .tracker, .scheduler
                                          (reference: gst plugins)
  L2 algorithms  cova_tpu.ops.{cc,assignment,iou}, .tracker.kalman
                                          (reference: cova-rs/{sort,bbox})
  L1 models      cova_tpu.models          (reference: utils/model, nvinfer)
  L0 codec       cova_tpu.codec + csrc/   (reference: patched FFmpeg fork)
"""

__version__ = "0.1.0"

from cova_tpu import config as config  # noqa: F401
from cova_tpu import types as types  # noqa: F401


import os as _os
import pathlib as _pathlib

_REPO = _pathlib.Path(__file__).resolve().parent.parent


def compile_cache_dir(environ=None) -> str:
    """Where compiled programs persist: $JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else a fixed directory in the checkout —
    a fixed path, so every process and every run on this checkout hits
    the same cache."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO / ".jax_cache")


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
