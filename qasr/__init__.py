"""qasr — quaternion-CNN end-to-end speech recognition in JAX.

A JAX/XLA framework with the capabilities of
Orkis-Research/Quaternion-Convolutional-Neural-Networks-for-End-to-End-
Automatic-Speech-Recognition (Parcollet et al., Interspeech 2018,
arXiv:1806.07789). See SURVEY.md for the reference analysis this is built to.

The symbols below are the user-facing surface, re-exported lazily so that
`import qasr` costs nothing until a symbol is touched (the jax import is
the expensive part).
"""

__version__ = "0.2.0"

# name -> submodule that defines it
_API = {
    # layers / models (reference: QuaternionConv1D/2D, QuaternionDense, ...)
    "QConv": "qasr.models.layers",
    "QDense": "qasr.models.layers",
    "QBatchNorm": "qasr.models.layers",
    "PReLU": "qasr.models.layers",
    "QCNNEncoder": "qasr.models.qcnn",
    "RealCNNEncoder": "qasr.models.qcnn",
    # functional ops
    "qconv": "qasr.ops.qlinalg",
    "qconv_fast10": "qasr.ops.qlinalg",
    "qdense": "qasr.ops.qlinalg",
    "qdense_fast8": "qasr.ops.qlinalg",
    "qconv_fast8_stacked": "qasr.ops.qlinalg",
    "qconv_fast10_stacked": "qasr.ops.qlinalg",
    "tf_packed_to_stacked": "qasr.models.layers",
    "stacked_to_tf_packed": "qasr.models.layers",
    "hamilton_product": "qasr.ops.quaternion",
    "quaternion_init": "qasr.ops.initializers",
    "quaternion_initializer": "qasr.ops.initializers",
    # loss / decode
    "ctc_loss": "qasr.ops.ctc",
    "ctc_greedy_decode": "qasr.ops.ctc",
    "ctc_beam_search_decode": "qasr.decode.beam",
    "batch_per": "qasr.decode.scoring",
    # inference
    "Transcriber": "qasr.infer",
    "featurize_waveform": "qasr.features.frontend",
    # config / training
    "get_config": "qasr.configs",
    "train": "qasr.train.loop",
    "evaluate": "qasr.train.loop",
    "build_model": "qasr.train.state",
    # parallelism
    "make_mesh": "qasr.parallel.mesh",
    "ctc_loss_seq_parallel": "qasr.parallel.seq_parallel",
    "qconv2d_seq_parallel": "qasr.parallel.seq_parallel",
}

__all__ = ["__version__", *sorted(_API)]


def __getattr__(name: str):
    target = _API.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target), name)
    globals()[name] = value  # cache for next access
    return value


def __dir__():
    return __all__
