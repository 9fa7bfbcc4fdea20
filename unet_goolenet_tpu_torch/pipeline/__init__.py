"""Inference engine, the two-stage pipeline and the serving export of the port.

The names below resolve on first use (PEP 562), so that importing one
submodule, such as `pipeline.export` for `load_serving`, imports no other:
a loaded serving artifact needs no model code.
"""

import importlib

_HOME = {"TwoStagePipeline": "two_stage", "extract_roi": "two_stage",
         "preprocess_gray": "two_stage", "preprocess_gray_padded": "two_stage",
         "segment": "two_stage", "ServingArtifact": "export", "export_serving": "export",
         "load_serving": "export"}

__all__ = sorted(_HOME)


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = value
    return value
