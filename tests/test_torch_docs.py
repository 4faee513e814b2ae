"""The port's public-API doctests: the counterparts of the ten modules whose
examples tools/check_docs.py runs for the JAX package (``DOCTEST_MODULES``),
each run with ``doctest.testmod``. Every module carries at least one example
and none fails. The examples run on the CPU (``device="cpu"``)."""
import doctest
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = (
    "repro_torch.core.summary_engine",
    "repro_torch.core.estimation_engine",
    "repro_torch.core.error_engine",
    "repro_torch.core.refinement",
    "repro_torch.core.pipeline",
    "repro_torch.core.streaming",
    "repro_torch.dist.multihost",
    "repro_torch.serve.engine",
    "repro_torch.serve.scheduler",
    "repro_torch.kernels.tuning",
)


def test_modules_are_the_counterparts_of_check_docs():
    """The list is the JAX gate's, module for module (read from its
    source, which imports nothing of JAX at module level)."""
    src = (REPO / "tools" / "check_docs.py").read_text()
    for name in MODULES:
        assert f'"{name.replace("repro_torch.", "repro.")}"' in src, name


@pytest.mark.parametrize("name", MODULES)
def test_doctests_run(name):
    result = doctest.testmod(importlib.import_module(name))
    assert result.attempted >= 1, f"{name} has no example"
    assert result.failed == 0, f"{name}: {result.failed} failed"
