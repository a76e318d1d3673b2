"""PyTorch port, context-parallel attention and K3 split for token-sharded
blocks.

* ``ops.context_parallel``'s ``context_parallel_attention`` and
  ``ring_attention`` in 4 gloo processes (``tests/torch_mp_worker.py``
  ``context_parallel``) against ``yat_tpu/ops/context_parallel.py`` under
  ``jax.shard_map`` on 4 of the conftest's virtual CPU devices: the
  forward at 2e-5 (the queries whole on every device, the keys and values
  sharded; and the ring with the queries sharded too), the ring's
  gradients at 2e-4 against the JAX ring's, the all-reduce form's against
  the JAX gradient of one-device attention (the JAX form has none: its
  ``pmax`` has no derivative rule).
* K3s and K3a (``ops.attention.linear_attention_state`` and
  ``linear_attention_apply``): their plain halves composed are
  ``linear_attention_ref`` bit for bit (the token-sharded SANA steps of
  ``tests/test_torch_port_tp_sp.py`` run them across processes); on a
  card (``gpu`` marker) each
  kernel against its plain half, bf16 and fp32, at the shapes of a
  ``{sp: 2}`` SANA-0.6B step.

JAX is imported inside the tests that compare with it, so the card tests
run without JAX:

    python -m pytest tests/test_torch_port_context_parallel.py -m gpu \\
        --noconftest
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_multiprocess import (launch_in_background,
                                                results)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)
from yat_tpu_torch.ops import attention as TA

WORLD = 4


@pytest.fixture(scope="module")
def cp_runs(tmp_path_factory):
    """q ``[2, 16, 2, 8]`` and k/v ``[2, 32, 2, 8]``, the port's 4
    processes on them, and the JAX functions on 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from yat_tpu.ops.context_parallel import (context_parallel_attention,
                                              ring_attention)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("context_parallel")
    np.savez(tmp / "context_parallel.npz", q=q, k=k, v=v)
    # the port's processes run while the JAX functions compile
    join = launch_in_background("context_parallel", WORLD, tmp)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("ctx",))
    kv = P(None, "ctx")

    def mapped(fn, q_spec, vma=True):
        return jax.shard_map(lambda a, b, c: fn(a, b, c, "ctx"), mesh=mesh,
                             in_specs=(q_spec, kv, kv), out_specs=q_spec,
                             check_vma=vma)

    def one_device(a, b, c):
        logits = jnp.einsum("bqhd,bkhd->bhqk", a, b) * a.shape[-1] ** -0.5
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, -1), c)

    def loss_grads(fn):
        return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                        argnums=(0, 1, 2))(q, k, v)

    cp = mapped(context_parallel_attention, P())
    ring = mapped(ring_attention, P(), vma=False)
    ring_sharded = mapped(ring_attention, kv, vma=False)
    want = {"cp/out": cp(q, k, v), "ring/out": ring(q, k, v),
            "ring_sharded/out": ring_sharded(q, k, v)}
    for name, fn in (("cp", one_device), ("ring_sharded", ring_sharded)):
        for n, g in zip(("dq", "dk", "dv"), loss_grads(fn)):
            want[f"{name}/{n}"] = g
    want = {n: np.asarray(x) for n, x in want.items()}
    join()
    return want, results(tmp, "context_parallel", WORLD)


def _shard(x, rank, axis=1):
    n = x.shape[axis] // WORLD
    return np.take(x, range(rank * n, (rank + 1) * n), axis=axis)


@pytest.mark.parametrize("name", ["cp", "ring", "ring_sharded"])
def test_context_parallel_forward_matches_jax(cp_runs, name):
    """Each process's output against the JAX function's under
    ``shard_map`` (the whole output where the queries are whole, this
    process's rows where they are sharded), 2e-5."""
    want, res = cp_runs
    for rank, r in enumerate(res):
        w = want[f"{name}/out"]
        if name == "ring_sharded":
            w = _shard(w, rank)
        np.testing.assert_allclose(r[f"{name}/out"], w, atol=2e-5)


@pytest.mark.parametrize("name", ["cp", "ring_sharded"])
def test_context_parallel_gradients_match_jax(cp_runs, name):
    """The gradients of the sum of squares of the output: each process's
    key and value shards and its queries' against the JAX gradients (the
    JAX ring under ``shard_map`` with every input sharded; one-device
    attention for the all-reduce form, whose queries are whole and whose
    query gradient every process holds whole), 2e-4."""
    want, res = cp_runs
    for rank, r in enumerate(res):
        for n in ("dq", "dk", "dv"):
            w = want[f"{name}/{n}"]
            if n != "dq" or name == "ring_sharded":
                w = _shard(w, rank)
            np.testing.assert_allclose(r[f"{name}/{n}"], w, atol=2e-4,
                                       err_msg=f"{name} {n}")


# ---------------------------------------------------------------------------
# K3s and K3a
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_kv", [False, True])
def test_plain_halves_compose_to_linear_attention_ref(dtype, round_kv):
    """K3s's plain version then K3a's equal ``linear_attention_ref`` bit
    for bit, NaN rows included."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, 3, 16), generator=g).to(dtype)
               for _ in range(3))
    k[1, 7, 2, 5] = float("nan")
    kv, ksum = TA.linear_attention_state_ref(k, v)
    assert kv.shape == (2, 3, 16, 16) and ksum.shape == (2, 3, 16)
    assert kv.dtype == ksum.dtype == torch.float32
    got = TA.linear_attention_apply_ref(q, kv, ksum, 1e-15, round_kv)
    want = TA.linear_attention_ref(q, k, v, 1e-15, round_kv)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_cpu_tensors_take_the_plain_halves():
    """On CPU tensors the wrappers are the plain halves and launch
    nothing."""
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 8, 2, 8), generator=g) for _ in range(3))
    reset_launch_counts()
    kv, ksum = TA.linear_attention_state(k, v)
    out = TA.linear_attention_apply(q, kv, ksum, 1e-15, True)
    counts = launch_counts()
    assert counts["linear_attention_state"] == 0
    assert counts["linear_attention_apply"] == 0
    assert torch.equal(out, TA.linear_attention_ref(q, k, v, 1e-15, True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_context_parallel.py -m gpu "
                    "--noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# |kernel - plain| <= atol + rtol*|plain| (chip_smoke's TOL for K3)
CARD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 128, 36, 32), (2, 17, 4, 64)])
def test_card_state_and_apply_kernels(cuda, dtype, shape):
    """K3s and K3a each launch once and hold their plain halves (the
    state in fp32 at 1e-5 of its largest entry; the apply at the storage
    type's tolerance, with and without the rounded state)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    s0, a0 = TA.LINEAR_ATTENTION_STATE.launches, \
        TA.LINEAR_ATTENTION_APPLY.launches
    kv, ksum = TA.linear_attention_state(k, v)
    want_kv, want_ksum = TA.linear_attention_state_ref(k, v)
    torch.testing.assert_close(kv, want_kv, rtol=1e-5,
                               atol=1e-5 * float(want_kv.abs().max()))
    torch.testing.assert_close(ksum, want_ksum, rtol=1e-5,
                               atol=1e-5 * float(want_ksum.abs().max()))
    atol, rtol = CARD_TOL[dtype]
    for round_kv in (True, False):
        out = TA.linear_attention_apply(q, want_kv, want_ksum, 1e-15,
                                        round_kv)
        torch.testing.assert_close(
            out.float(), TA.linear_attention_apply_ref(
                q, want_kv, want_ksum, 1e-15, round_kv).float(),
            atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    assert TA.LINEAR_ATTENTION_STATE.launches == s0 + 1
    assert TA.LINEAR_ATTENTION_APPLY.launches == a0 + 2
