"""Profiler annotations around the port's layers, for traced runs only.

The port records host spans of its own (core/obs.py) but no profiler
ranges, so a traced window would show its host work only as gaps
between kernels. In a ``--trace 1`` run the harness wraps the calls
into each layer in ``torch.profiler.record_function``, so the device
timeline's idle gaps are labelled by the layer the host was in. The
wrappers change no argument and no result. An untraced run never calls
`install`.
"""
from __future__ import annotations

import functools
import importlib
import inspect
from typing import List, Tuple

import torch

# (module, attribute path, label): the label names the layer, as
# PERF.md's list of layers does
TARGETS: List[Tuple[str, str, str]] = [
    ("repro_torch.models.gnn", "norm_csr", "model.norm_csr"),
    ("repro_torch.sparse.csr", "CSR.transpose_with_perm", "csr.transpose"),
    ("repro_torch.core.features", "InputFeatures.from_csr", "features.extract"),
    ("repro_torch.core.scheduler", "AutoSage.decide", "scheduler.decide"),
    ("repro_torch.core.scheduler", "AutoSage.decide_attention", "pipeline.decide"),
    ("repro_torch.core.scheduler", "AutoSage.build_runner", "scheduler.build_runner"),
    ("repro_torch.core.registry", "Variant.timed_prepare", "layouts.prepare"),
]


def _wrap(fn, label):
    @functools.wraps(fn)
    def annotated(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return annotated


def install() -> None:
    """Wrap every target once (idempotent)."""
    for module, path, label in TARGETS:
        owner = importlib.import_module(module)
        *outer, name = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        static = inspect.getattr_static(owner, name)
        fn = static.__func__ if isinstance(static, (classmethod, staticmethod)) else static
        if getattr(fn, "_bench_label", None):
            continue
        wrapped = _wrap(fn, label)
        wrapped._bench_label = label
        if isinstance(static, classmethod):
            wrapped = classmethod(wrapped)
        elif isinstance(static, staticmethod):
            wrapped = staticmethod(wrapped)
        setattr(owner, name, wrapped)
