"""The port's costliest shared test worlds are computed ahead.

Under pytest-xdist (`--dist load`), a test whose `once_per_test_run` world
is still being computed waits on its lock, and its worker idles; the
heavy worlds belong to modules late in the collection order. This module
comes first of the port's: its test starts, in the background, one process
per queue of tests/torch_worlds_ahead.py QUEUES, which computes those
worlds into the directories the workers share, each at most once. The
tests that read a world still compute it themselves when they come first.
"""

import importlib
import os
import pathlib
import subprocess
import sys

from tests import torch_worlds_ahead as ahead

ROOT = pathlib.Path(__file__).resolve().parents[1]
_STARTED = []           # the processes, kept for the session


def test_the_costliest_worlds_are_computed_ahead(tmp_path_factory):
    """Each queued world names a function of its module; under xdist one
    process per queue runs (its log beside the worlds). In one process
    nothing is shared, so nothing starts."""
    for queue in ahead.QUEUES:
        for name, module, function, how in queue:
            assert callable(getattr(importlib.import_module(module),
                                    function)), (name, module, function)
            assert how in ("root", "value"), name
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return
    parent = tmp_path_factory.getbasetemp().parent
    for i in range(len(ahead.QUEUES)):
        with open(parent / f"ahead{i}.log", "w") as log:
            _STARTED.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_worlds_ahead",
                 str(parent), str(i)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(
                    None, (str(ROOT), os.environ.get("PYTHONPATH")))))))
    assert all(p.poll() in (None, 0) for p in _STARTED)
