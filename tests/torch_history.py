"""A fresh slot-count and feature-set history for the port's test modules.

Both packages keep their solve's cache-key hysteresis process-wide
(``utils/compilecache.py``: ``_slots_seen`` and ``_features_seen``): a
solve's slot count and phase plan depend on what the process solved before.
Under ``--dist loadfile`` a module inherits what earlier modules of its
worker left there, so a comparison of the two packages, or a pin taken from
a fresh process, would depend on the order of the files, and a reference
module after a port module would inherit the port's slot counts.

Every ``tests/test_torch_*.py`` that drives a JAX solve binds the autouse
``isolated_history`` fixture (``isolated_history =
torch_history.isolated_history``): for the module's duration both packages
start from empty sets, as a fresh process does, and afterwards each
package's own sets are back, as the module found them.
"""

import contextlib

import pytest

from karpenter_core_tpu.utils import compilecache as jcc
from karpenter_core_tpu_torch.utils import compilecache as tcc

HISTORY = ("_slots_seen", "_features_seen")


@contextlib.contextmanager
def fresh_history():
    """Empty slot-count and feature-set histories in both packages for the
    block; the sets that were there are put back after it."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcc, tcc):
            for name in HISTORY:
                mp.setattr(module, name, set())
        yield


@pytest.fixture(scope="module", autouse=True)
def isolated_history():
    with fresh_history():
        yield
