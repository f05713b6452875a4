"""QABAS, quantization-aware basecaller architecture search: the search
space, the latency table (from the H100 roofline of
``analysis/roofline.py``), the supernet search and its derived
config, and the serving-knob search that the launcher's
``--knob-search`` runs."""
from repro_torch.core.qabas.space import SearchSpace, DEFAULT_SPACE
from repro_torch.core.qabas.latency import latency_table, expected_latency
from repro_torch.core.qabas.search import QABASConfig, run_search, derive_config
from repro_torch.core.qabas.serving import (ServingKnobs, KnobResult,
                                            enumerate_knobs, measure_knobs,
                                            search_serving_knobs,
                                            format_knob_table)

__all__ = ["SearchSpace", "DEFAULT_SPACE", "latency_table",
           "expected_latency", "QABASConfig", "run_search", "derive_config",
           "ServingKnobs", "KnobResult", "enumerate_knobs", "measure_knobs",
           "search_serving_knobs", "format_knob_table"]
