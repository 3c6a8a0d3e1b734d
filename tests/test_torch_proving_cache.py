"""The port's on-disk proving-key cache (taiga_tpu_torch.core.proving), on
the CPU, with the cache directory moved to a temporary one.

A miss keygens and stores the key, and a lookup after the memory cache is
cleared loads it with the same verifying key; a changed source-closure
digest, or a changed file defining the circuit class, misses; a change to
any port source that shapes a key, the native engine's included, moves the
closure digest; a corrupt file is regenerated; two threads storing one key
at once leave a file that loads. The circuit is the Vamp-IR pyth logic at
K = 7 (keygen well under a second), also through a subclass defined in a
module file of the test's own, which the test edits.
"""

import importlib.util
import os
import shutil
import sys
import threading

import pytest

from taiga_tpu_torch.circuits.vamp_ir import VampIRResourceLogicCircuit
from taiga_tpu_torch.core import proving as PR
from taiga_tpu_torch.plonk import keygen as KG

K = 7
PYTH = """
pub R;
def pyth a b c = {
  a^2 + b^2 = c^2
};
pyth x y R;
"""
LOCAL_MODULE = '''
from taiga_tpu_torch.circuits.vamp_ir import VampIRResourceLogicCircuit

SOURCE = {source!r}


class LocalPyth(VampIRResourceLogicCircuit.for_source(SOURCE)):
    """{doc}"""
'''


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The cache in tmp_path, an empty memory cache, and the keygens run
    (a list of class names)."""
    monkeypatch.setattr(PR, "_PK_DIR", str(tmp_path / "pk"))
    monkeypatch.setattr(PR, "_PK_CACHE", {})
    made = []
    real = KG.keygen

    def counted(circuit, k):
        made.append(type(circuit).__name__)
        return real(circuit, k)

    monkeypatch.setattr(KG, "keygen", counted)
    return made


def _files():
    return sorted(f for f in os.listdir(PR._PK_DIR) if f.endswith(".pkl"))


def _pyth():
    return VampIRResourceLogicCircuit.for_source(PYTH)


def test_a_miss_stores_and_a_later_lookup_loads(cache):
    pk = PR.get_proving_key(_pyth(), K)
    assert cache == [_pyth().__name__]
    assert len(_files()) == 1
    assert PR.get_proving_key(_pyth(), K) is pk  # memory
    PR._PK_CACHE.clear()
    loaded = PR.get_proving_key(_pyth(), K)
    assert cache == [_pyth().__name__]  # no second keygen
    assert loaded is not pk
    assert loaded.vk.to_bytes() == pk.vk.to_bytes()
    assert (loaded.fixed_mont() == pk.fixed_mont()).all()
    assert (loaded.sigma_mont() == pk.sigma_mont()).all()


def test_a_changed_closure_digest_misses(cache, monkeypatch):
    PR.get_proving_key(_pyth(), K)
    PR._PK_CACHE.clear()
    monkeypatch.setattr(PR, "_SRC_CLOSURE_DIGEST", "0" * 32)
    PR.get_proving_key(_pyth(), K)
    assert len(cache) == 2
    assert len(_files()) == 2


@pytest.mark.parametrize("rel", [
    os.path.join("native", "src", "pasta_host.cpp"), os.path.join("native", "__init__.py"),
    os.path.join("core", "constants.py"), os.path.join("circuits", "gadgets.py"),
    os.path.join("plonk", "keygen.py"), os.path.join("apps", "token.py"),
    os.path.join("crypto", "fields.py")])
def test_the_closure_covers_every_source_that_shapes_a_key(rel, tmp_path):
    """A copy of the port's sources has the port's closure digest; a change
    to any source that shapes a key, the native engine's C++ source among
    them, moves it."""
    copy = tmp_path / "pkg"
    shutil.copytree(PR._PKG_ROOT, copy, ignore=shutil.ignore_patterns(
        "*.so", "*.npz", "__pycache__", "build"))
    assert PR._closure_digest(str(copy)) == PR._source_closure_digest()
    with open(copy / rel, "ab") as f:
        f.write(b"\n")
    assert PR._closure_digest(str(copy)) != PR._source_closure_digest()


def _load_local(path, name, doc):
    path.write_text(LOCAL_MODULE.format(source=PYTH, doc=doc))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod.LocalPyth


def test_a_changed_defining_file_misses(cache, tmp_path, monkeypatch):
    name = "taiga_torch_pk_cache_local"
    monkeypatch.delitem(sys.modules, name, raising=False)
    path = tmp_path / "local_circuit.py"
    first = PR.get_proving_key(_load_local(path, name, "first version"), K)
    PR._PK_CACHE.clear()
    PR.get_proving_key(_load_local(path, name, "first version"), K)
    assert cache == ["LocalPyth"]  # the same file: loaded
    PR._PK_CACHE.clear()
    second = PR.get_proving_key(_load_local(path, name, "second version"), K)
    assert cache == ["LocalPyth", "LocalPyth"]  # the file changed: a miss
    assert second.vk.to_bytes() == first.vk.to_bytes()
    assert len(_files()) == 2


def test_a_corrupt_file_is_regenerated(cache):
    pk = PR.get_proving_key(_pyth(), K)
    (path,) = _files()
    full = os.path.join(PR._PK_DIR, path)
    with open(full, "r+b") as f:
        f.truncate(os.path.getsize(full) // 2)
    PR._PK_CACHE.clear()
    again = PR.get_proving_key(_pyth(), K)
    assert len(cache) == 2
    assert again.vk.to_bytes() == pk.vk.to_bytes()
    assert _files() == [path]
    PR._PK_CACHE.clear()
    assert PR.get_proving_key(_pyth(), K).vk.to_bytes() == pk.vk.to_bytes()
    assert len(cache) == 2  # the rewritten file loads


def test_concurrent_stores_leave_a_loadable_file(cache):
    """Eight threads store one key over and over while four load it: once
    the file is there, every load finds a whole key (each writer writes a
    file of its own and moves it into place), and no temporary file is
    left behind."""
    pk = PR.get_proving_key(_pyth(), K)
    (path,) = _files()
    full = PR.pk_cache_path(_pyth(), K)
    assert full == os.path.join(PR._PK_DIR, path)
    barrier = threading.Barrier(12)
    failed_loads = []

    def store():
        barrier.wait()
        for _ in range(20):
            PR._pk_store(full, pk)

    def load():
        barrier.wait()
        for _ in range(40):
            if PR._pk_load(full, K) is None:
                failed_loads.append(1)

    threads = [threading.Thread(target=store) for _ in range(8)]
    threads += [threading.Thread(target=load) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not failed_loads
    assert os.listdir(PR._PK_DIR) == [path]
    loaded = PR._pk_load(full, K)
    assert loaded is not None and loaded.vk.to_bytes() == pk.vk.to_bytes()
