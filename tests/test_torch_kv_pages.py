"""The port's copy of the host-side KV page pool (``models/kv_pages.py``)
held to the JAX package's own cases: every test of
``tests/test_kv_pages.py`` runs once against the reference module and once
with the port's ``KVPagePool``, ``chain_keys`` and ``hash_page_data``
patched in its place, and a random sequence of pool operations gives the
same leases, stats and keys from both."""

import importlib.util
import inspect
import os

import numpy as np
import pytest

import tensorflowonspark_tpu.models.kv_pages as ref
import tensorflowonspark_tpu_torch.models.kv_pages as port

_spec = importlib.util.spec_from_file_location(
    "reference_kv_pages_tests", os.path.join(os.path.dirname(__file__), "test_kv_pages.py"))
REF_TESTS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF_TESTS)
CASES = sorted(n for n, f in vars(REF_TESTS).items()
               if n.startswith("test_") and inspect.isfunction(f))


@pytest.mark.parametrize("impl", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, impl, monkeypatch):
    if impl == "port":
        monkeypatch.setattr(REF_TESTS, "KVPagePool", port.KVPagePool)
        for name in ("KVPagePool", "chain_keys", "hash_page_data"):
            monkeypatch.setattr(ref, name, getattr(port, name))
    getattr(REF_TESTS, case)()


def _lease(lease):
    return None if lease is None else (lease.page_ids, lease.n_shared, lease.tail_start,
                                       lease.outcome)


def test_random_operations_give_the_reference_results():
    rng = np.random.default_rng(0)
    pools = [ref.KVPagePool(12, 4), port.KVPagePool(12, 4)]
    leases: list[list] = [[], []]
    prompts = [rng.integers(0, 3, n).astype(np.int32) for n in (5, 9, 9, 13, 4, 16)]
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not leases[0]:
            prompt = prompts[rng.integers(0, len(prompts))]
            total = len(prompt) + int(rng.integers(0, 6))
            out = [p.admit(prompt, total) for p in pools]
            assert _lease(out[0]) == _lease(out[1])
            if out[0] is not None:
                for i in range(2):
                    pools[i].commit(out[i])
                    leases[i].append(out[i])
        else:
            j = int(rng.integers(0, len(leases[0])))
            for i in range(2):
                pools[i].release(leases[i].pop(j))
        assert pools[0].stats() == pools[1].stats()
    assert port.chain_keys(prompts[5], 4) == ref.chain_keys(prompts[5], 4)
    data = [rng.standard_normal((3, 4, 2, 2)).astype(np.float32)]
    assert port.hash_page_data(data, 3) == ref.hash_page_data(data, 3)
