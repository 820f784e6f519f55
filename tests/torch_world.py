"""Run one suite of ``tests/torch_model_parallel_worker.py`` in a gloo
world of CPU processes while the test computes the JAX side."""

import os
import pickle
import subprocess
import sys

from tensorflowonspark_tpu_torch.util import get_free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(suite: str, cases: dict, jax_side, wd, world: int = 4, killed=()):
    """Start ``world`` ranks of ``suite``, hand them ``cases`` (pickled
    into ``wd``), run ``jax_side()`` meanwhile, and return ``(its result,
    [each rank's output])``.  The ranks in ``killed`` must end SIGKILLed
    (the suite kills them), every other rank with code 0."""
    port = get_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_model_parallel_worker", suite,
                               str(r), str(world), str(port), str(wd)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        tmp = wd / "inputs.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(cases, f)
        os.rename(tmp, wd / "inputs.pkl")               # the ranks wait for it
        want = jax_side()
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [-9 if r in killed else 0 for r in range(world)]
    assert [p.returncode for p in procs] == codes, "\n".join(logs)[-6000:]
    got = []
    for r in range(world):
        with open(wd / f"out.{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return want, got
