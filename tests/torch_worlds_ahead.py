"""Computes ahead, in the background, the shared worlds of the port's tests
that cost the most, into the directories `once_per_test_run`
(tests/test_torch_train_loop.py) shares under pytest-xdist:

    python -m tests.torch_worlds_ahead <basetemp's parent> <queue>

tests/test_torch_ahead.py starts one process per queue of QUEUES early in
a test run. Under `--dist load` every worker that reaches a test of a
world still being computed waits on its lock, idle; a world computed ahead
is done, or nearer done, by then. Each world is computed at most once, by
whoever takes its lock first (a process of this module skips a world whose
lock is held); a process ends with the worker that started it.
"""

import ctypes
import importlib
import os
import pathlib
import signal
import sys

# (once_per_test_run's name, module, function, how): "root" -> the
# function writes the world's files into its directory; "value" ->
# computed_once's value of the function. Each queue in the order its
# worlds are needed (the order of their modules).
QUEUES = (
    (("torch_eval_cli_runs", "tests.test_torch_eval_cli", "run_both_clis",
      "root"),
     ("torch_model_world", "tests.test_torch_model", "compute_world",
      "value"),
     ("torch_model_long_world", "tests.test_torch_model",
      "compute_long_world", "value"),
     ("torch_sp_world", "tests.test_torch_sp", "compute_sp", "root"),
     ("torch_tal", "tests.test_torch_tal", "write_tal", "root"),
     ("torch_train_loop_jax_run", "tests.test_torch_train_loop",
      "compute_jax_runs", "root")),
    (("torch_contrastive_world", "tests.test_torch_contrastive_train",
      "compute_world", "root"),
     ("torch_parallel_world", "tests.test_torch_parallel", "compute", "root"),
     ("torch_text_train_worlds", "tests.test_torch_text_train",
      "compute_worlds", "root"),
     ("torch_train_loop_port_run", "tests.test_torch_train_loop",
      "compute_port_runs", "root"),
     ("torch_train_step_world", "tests.test_torch_train_step",
      "compute_world", "root"),
     ("torch_train_step_long_video", "tests.test_torch_train_step",
      "compute_long_video_steps", "root")),
)


def main(parent: str, queue: int) -> None:
    # end with the worker that started this process (PR_SET_PDEATHSIG)
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)
    if os.getppid() == 1:
        return
    import tests.conftest  # noqa: F401  (the suite's JAX settings)
    from tests.test_torch_train_loop import compute_once, value_writer
    for name, module, function, how in QUEUES[queue]:
        fn = getattr(importlib.import_module(module), function)
        compute_once(pathlib.Path(parent) / name, f"ahead{queue}",
                     fn if how == "root" else value_writer(fn), wait=False)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
