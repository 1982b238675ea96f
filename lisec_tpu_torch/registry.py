"""Name -> class registries for models and datasets (SURVEY.md §3.3)."""

from __future__ import annotations

from typing import Any, Callable, Dict

_MODELS: Dict[str, Callable[..., Any]] = {}
_DATASETS: Dict[str, Callable[..., Any]] = {}
_PIPELINES: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(cls):
        _MODELS[name] = cls
        return cls
    return deco


def register_dataset(name: str):
    def deco(cls):
        _DATASETS[name] = cls
        return cls
    return deco


def register_pipeline(name: str):
    """A pipeline bundles model + preprocessing + postprocessing + losses
    for one workload family (cls / partseg / detection / rangeseg)."""
    def deco(cls):
        _PIPELINES[name] = cls
        return cls
    return deco


def get_model(name: str):
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_MODELS)}")
    return _MODELS[name]


def get_dataset(name: str):
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_DATASETS)}")
    return _DATASETS[name]


def get_pipeline(name: str):
    if name not in _PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; known: {sorted(_PIPELINES)}")
    return _PIPELINES[name]


def list_models():
    return sorted(_MODELS)


def list_datasets():
    return sorted(_DATASETS)
