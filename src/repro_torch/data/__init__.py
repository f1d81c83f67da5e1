"""Deterministic synthetic data pipeline (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticLM, make_batch_specs

__all__ = ["SyntheticLM", "make_batch_specs"]
