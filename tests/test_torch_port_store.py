"""The port's stores and rendezvous (``pytorch_distributed_tpu_torch.
distributed``) against the contract of ``tests/test_store.py``: the same
cases, parametrised where one body serves several stores, plus the c10d
mappings the port adds (a zero timeout never blocks, c10d's timeout error
is a ``StoreTimeoutError``) and ``init_process_group(store=...)`` over
each kind of port store; and a process that imports the port's
distributed, checkpoint and elastic packages and both training entry
points holds no JAX module."""

import os
import subprocess
import sys
import threading
import time
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from tests import _torch_port_elastic as el

from pytorch_distributed_tpu_torch import distributed as pdist
from pytorch_distributed_tpu_torch.distributed import (
    FileStore,
    HashStore,
    PrefixStore,
    StoreTimeoutError,
    TCPStore,
    rendezvous,
)

torch.set_num_threads(2)


def _tcp(tmp_path):
    return TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                    timeout=timedelta(seconds=10))


def _hash(tmp_path):
    return HashStore(timeout=timedelta(seconds=10))


def _file(tmp_path):
    return FileStore(str(tmp_path / "fs"), timeout=timedelta(seconds=10))


def _prefix(tmp_path):
    return PrefixStore("pg", HashStore(timeout=timedelta(seconds=10)))


KINDS = {"tcp": _tcp, "hash": _hash, "file": _file, "prefix": _prefix}


@pytest.fixture(params=sorted(KINDS))
def store(request, tmp_path):
    s = KINDS[request.param](tmp_path)
    yield s
    if isinstance(s, TCPStore):
        s.close()


@pytest.fixture()
def tcp_store():
    s = TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                 timeout=timedelta(seconds=10))
    yield s
    s.close()


def client_for(master: TCPStore) -> TCPStore:
    return TCPStore("127.0.0.1", master.port, is_master=False,
                    timeout=timedelta(seconds=10))


# -- the contract, every store -------------------------------------------

def test_set_get(store):
    store.set("k", b"hello")
    assert store.get("k") == b"hello"
    store.set("k", "text")           # str accepted
    assert store.get("k") == b"text"


def test_get_timeout(store):
    t0 = time.monotonic()
    with pytest.raises(StoreTimeoutError):
        store.get("never", timeout=timedelta(milliseconds=100))
    assert time.monotonic() - t0 < 5.0


def test_zero_timeout_is_immediate_not_default(store):
    """An explicit zero timedelta means "do not block" (c10d reads zero
    as no timeout at all: the port maps it to a check)."""
    t0 = time.monotonic()
    with pytest.raises(StoreTimeoutError):
        store.get("missing", timeout=timedelta(0))
    with pytest.raises(StoreTimeoutError):
        store.wait(["missing"], timeout=timedelta(0))
    with pytest.raises(StoreTimeoutError):   # c10d rounds this to 0 ms
        store.wait(["missing"], timeout=timedelta(microseconds=400))
    store.set("here", b"1")
    store.wait(["here"], timeout=timedelta(0))
    assert store.get("here", timeout=timedelta(0)) == b"1"
    assert time.monotonic() - t0 < 5.0


def test_timeout_error_is_a_timeout_error(store):
    with pytest.raises(TimeoutError):
        store.wait(["a"], timeout=timedelta(milliseconds=50))


def test_add_wait_check(store):
    assert store.add("n", 5) == 5
    assert store.add("n", -2) == 3
    assert not store.check(["a", "b"])
    store.set("a", b"1")
    with pytest.raises(StoreTimeoutError):
        store.wait(["a", "b"], timeout=timedelta(milliseconds=100))
    store.set("b", b"2")
    store.wait(["a", "b"], timeout=timedelta(seconds=1))
    assert store.check(["a", "b", "n"])


def test_get_nowait(store):
    assert store.get_nowait("absent") is None
    store.set("present", b"v")
    assert store.get_nowait("present") == b"v"


def test_compare_set(store):
    assert store.compare_set("cs", b"", b"v1") == b"v1"      # missing + empty
    assert store.compare_set("cs", b"nope", b"v2") == b"v1"  # wrong expected
    assert store.compare_set("cs", b"v1", b"v2") == b"v2"    # swaps
    assert store.compare_set("cs2", b"e", b"d") == b"e"      # missing + set
    assert not store.check(["cs2"])


def test_delete_and_num_keys(store):
    base = store.num_keys()
    store.set("x", b"1")
    store.set("y", b"2")
    assert store.num_keys() == base + 2
    assert store.delete_key("x")
    assert not store.delete_key("x")
    assert store.num_keys() == base + 1


# -- TCP -------------------------------------------------------------------

def test_tcp_get_blocks_until_set(tcp_store):
    client = client_for(tcp_store)
    result = {}
    started = threading.Event()

    def getter():
        started.set()
        result["v"] = client.get("slow", timeout=timedelta(seconds=10))

    t = threading.Thread(target=getter)
    t.start()
    started.wait(5)
    assert "v" not in result
    tcp_store.set("slow", b"done")
    t.join(timeout=10)
    assert not t.is_alive() and result["v"] == b"done"
    client.close()


def test_tcp_add_atomic_across_clients(tcp_store):
    clients = [client_for(tcp_store) for _ in range(4)]

    def bump(c):
        for _ in range(50):
            c.add("ctr", 1)

    threads = [threading.Thread(target=bump, args=(c,)) for c in clients]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert tcp_store.add("ctr", 0) == 200
    [c.close() for c in clients]


def test_tcp_barrier(tcp_store):
    clients = [client_for(tcp_store) for _ in range(3)]
    done = []

    def arrive(i, c):
        c.barrier_id("b0", i, 4, timeout=timedelta(seconds=10))
        done.append(i)

    threads = [threading.Thread(target=arrive, args=(i, c))
               for i, c in enumerate(clients)]
    [t.start() for t in threads]
    tcp_store.wait(["b0/arrived"], timeout=timedelta(seconds=5))
    while tcp_store.add("b0/arrived", 0) < 3:
        time.sleep(0.01)
    assert not done                  # 3 of 4 arrived: everyone blocked
    tcp_store.barrier_id("b0", 3, 4, timeout=timedelta(seconds=10))
    [t.join(timeout=10) for t in threads]
    assert sorted(done) == [0, 1, 2]
    [c.close() for c in clients]


def test_tcp_large_value(tcp_store):
    blob = os.urandom(2_000_000)
    tcp_store.set("big", blob)
    assert tcp_store.get("big") == blob


def test_tcp_ping_and_ephemeral_port(tcp_store):
    assert tcp_store.port > 0        # port 0: a free port was bound
    assert tcp_store.ping()


def test_tcp_ops_after_close_raise():
    s = TCPStore("127.0.0.1", 0, is_master=True)
    s.set("k", b"v")
    s.close()
    s.close()                        # idempotent
    assert not s.ping()
    with pytest.raises(RuntimeError, match="closed"):
        s.set("k2", b"v")
    with pytest.raises(RuntimeError, match="closed"):
        s.get("k", timeout=timedelta(milliseconds=50))


def test_tcp_concurrent_blocking_get_does_not_starve():
    """A thread stuck in a blocking get must not hold up the other threads'
    calls on the same TCPStore (a pool of connections)."""
    s = TCPStore("127.0.0.1", 0, is_master=True,
                 timeout=timedelta(seconds=10))
    raised = []

    def blocked():
        try:
            s.get("never", timeout=timedelta(seconds=3))
        except StoreTimeoutError:
            raised.append(True)

    t = threading.Thread(target=blocked)
    t.start()
    while s._n_conns < 2 and t.is_alive():
        s.check(["x"])               # lets the getter take a connection
        time.sleep(0.01)
    t0 = time.monotonic()
    s.set("quick", b"1")
    assert s.get("quick") == b"1"
    assert time.monotonic() - t0 < 1.0
    t.join(timeout=10)
    assert not t.is_alive() and raised == [True]
    s.close()


def test_file_store_two_handles(tmp_path):
    a = FileStore(str(tmp_path / "fs"))
    b = FileStore(str(tmp_path / "fs"))  # a second "process"
    a.set("k", b"v")
    assert b.get("k") == b"v"
    assert a.add("n", 2) == 2
    assert b.add("n", 3) == 5
    assert b.compare_set("k", b"v", b"w") == b"w"
    assert a.get("k") == b"w"
    assert a.delete_key("k")
    assert a.num_keys() == 1         # n remains


def test_prefix_namespacing():
    base = HashStore()
    p1, p2 = PrefixStore("pg1", base), PrefixStore("pg2", base)
    p1.set("k", b"one")
    p2.set("k", b"two")
    assert (p1.get("k"), p2.get("k")) == (b"one", b"two")
    assert base.get("pg1/k") == b"one"
    # the c10d view keeps the same namespace
    assert p1.as_c10d().get("k") == b"one"


# -- rendezvous --------------------------------------------------------------

def test_rendezvous_tcp_scheme():
    master = TCPStore("127.0.0.1", 0, is_master=True)
    store, rank, ws = rendezvous(
        f"tcp://127.0.0.1:{master.port}?rank=1&world_size=2")
    assert (rank, ws) == (1, 2)
    master.set("hello", b"x")
    assert store.get("hello") == b"x"
    store.close()
    master.close()


def test_rendezvous_env_scheme(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "0")  # rank 0 binds a free port
    store, rank, ws = rendezvous("env://")
    assert (rank, ws) == (0, 1)
    store.set("a", b"1")
    assert store.get("a") == b"1"
    store.close()


def test_rendezvous_file_scheme(tmp_path):
    store, rank, ws = rendezvous(f"file://{tmp_path}/rdzv?rank=0&world_size=1")
    assert (rank, ws) == (0, 1)
    store.set("x", b"y")
    assert store.get("x") == b"y"


def test_rendezvous_unknown_scheme():
    with pytest.raises(ValueError):
        rendezvous("quic://foo")


# -- a process group over a port store --------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_process_group_takes_a_port_store(kind, tmp_path):
    store = KINDS[kind](tmp_path)
    pdist.init_process_group(store=store, rank=0, world_size=1, device="cpu",
                             timeout=timedelta(seconds=30))
    try:
        t = torch.arange(4.0)
        dist.all_reduce(t)
        assert torch.equal(t, torch.arange(4.0))
        assert pdist.get_world_size() == 1
    finally:
        pdist.destroy_process_group()
        if isinstance(store, TCPStore):
            store.close()


def test_port_packages_import_no_jax():
    code = ("import sys\n"
            "import pytorch_distributed_tpu_torch.distributed\n"
            "import pytorch_distributed_tpu_torch.checkpoint\n"
            "import pytorch_distributed_tpu_torch.elastic\n"
            "import pytorch_distributed_tpu_torch.elastic.run\n"
            "import pytorch_distributed_tpu_torch.examples.train_resnet_ddp\n"
            "import pytorch_distributed_tpu_torch.examples.train_gpt2\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'flax', 'optax', 'orbax', 'pytorch_distributed_tpu.'))"
            " or m == 'pytorch_distributed_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   env={**os.environ, **el.worker_env()})
