"""The port's parallel layer (percepnet_tpu_torch.parallel) on the CPU:
the mesh primitives, sharded enhance_chunk and the mesh StreamingServer
against the JAX package's over its 8-device virtual mesh, and the
collectives in a 2-process gloo group.

The same numpy-seeded inputs and JAX's initial parameters go through both
packages.  Bounds: 1e-4 of normalized PCM in f32 (the strict PCM gate),
5e-3 in bf16 (tests/test_parallel.py's bf16 mesh bound).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu import pipeline as j_pipeline
from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.parallel import mesh as j_pm
from percepnet_tpu.serve import StreamingServer as JStreamingServer
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import parallel
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.io.flat_npz import params_from_flat
from percepnet_tpu_torch.serve import StreamingServer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM_TOL = {"f32": 1e-4, "bf16": 5e-3}
DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def weights():
    """JAX's initial parameters and the port's model holding them."""
    jp = j_model.init_params(jax.random.PRNGKey(0))
    return jp, params_from_flat(j_params_to_flat(jax.device_get(jp)))


def _signal(bsz, n_frames, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((bsz, n_frames * C.FRAME_SIZE))
            ).astype(np.float32)


def test_sharded_enhance_chunk_matches_jax_mesh(weights):
    """enhance_chunk per shard of a 2-shard mesh (replicated model,
    slot-sharded signal and state) against JAX's enhance_chunk jitted
    over its 8-device mesh with the same shardings."""
    jp, model = weights
    bsz = 8
    sig = _signal(bsz, 8, seed=1)
    jmesh = j_pm.make_mesh()
    data_s = j_pm.batch_sharding(jmesh)
    step = jax.jit(j_pipeline.enhance_chunk,
                   in_shardings=(j_pm.replicated_sharding(jmesh), data_s,
                                 data_s),
                   out_shardings=(data_s, data_s))
    want, _ = step(j_pm.replicate(jmesh, jp), jax.device_put(sig, data_s),
                   jax.device_put(j_pipeline.init_pipeline_state(bsz),
                                  data_s))
    want = np.asarray(want)

    mesh = parallel.make_mesh(["cpu", "cpu"])
    models = parallel.replicate(mesh, model)
    signals = parallel.shard_batch(mesh, sig)
    states = parallel.shard_batch(
        mesh, pipeline.init_pipeline_state(bsz, device="cpu"))
    pcms, new_states = [], []
    for m, s, st in zip(models, signals, states):
        assert s.shape == (bsz // 2, sig.shape[1])
        assert st.synthesis_mem.shape[0] == bsz // 2
        pcm, st = pipeline.enhance_chunk(m, s, st, device="cpu")
        pcms.append(pcm.numpy())
        new_states.append(st)
    got = np.concatenate(pcms)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=PCM_TOL["f32"])
    # each shard's state is its streams' state: shard 1 alone, from its
    # own zero state, ends where the whole batch's rows 4..7 end
    _, whole = pipeline.enhance_chunk(
        model, sig, pipeline.init_pipeline_state(bsz, device="cpu"),
        device="cpu")
    np.testing.assert_array_equal(new_states[1].synthesis_mem.numpy(),
                                  whole.synthesis_mem[4:].numpy())


def _serve(srv, sig, n_streams):
    """Attach n_streams streams, feed sig's rows one frame per tick, and
    return each stream's output [n_streams, n_samples]."""
    sids = [srv.attach() for _ in range(n_streams)]
    got = {sid: [] for sid in sids}
    for t in range(sig.shape[1] // C.FRAME_SIZE):
        for i, sid in enumerate(sids):
            srv.submit(sid, sig[i, t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        out = srv.step()
        for sid in sids:
            got[sid].append(np.asarray(out[sid], np.float32))
    return np.stack([np.concatenate(got[sid]) for sid in sids])


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_mesh_server_matches_jax_mesh_server(weights, tier):
    """StreamingServer(mesh=2 shards) against JAX's StreamingServer over
    its 8-device mesh, 6 streams across both shards, 6 ticks.  JAX's
    persistent compilation cache is off for its server (a stale entry can
    return the server's tick graph as zeros; tests/test_torch_serving_
    bf16.py)."""
    jp, model = weights
    dtype, jdtype = DTYPES[tier]
    sig = _signal(6, 6, seed=2)
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        jsrv = JStreamingServer(jp, capacity=8, mesh=j_pm.make_mesh(),
                                model_dtype=jdtype)
        want = _serve(jsrv, sig, 6)
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
    srv = StreamingServer(model, capacity=8, model_dtype=dtype,
                          mesh=parallel.make_mesh(["cpu", "cpu"]))
    assert [len(st.synthesis_mem) for st in srv._states] == [4, 4]
    got = _serve(srv, sig, 6)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=PCM_TOL[tier])


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_mesh_server_int16_wire_against_plain_server(weights, tier):
    """With the int16 wire and frames_per_tick=2: a 1-shard mesh gives the
    plain server's output bit for bit; a 2-shard mesh stays within JAX's
    mesh-vs-one-device bounds (tests/test_parallel.py: 2e-4 f32, 5e-3
    bf16, of full scale; the GEMMs' batch changes their rounding); and
    detach / attach reaches the right shard's slot, from zero state."""
    _, model = weights
    dtype, _ = DTYPES[tier]
    pcm16 = np.trunc(np.clip(_signal(4, 6, seed=3) * 32768, -32768,
                             32767)).astype(np.int16)
    kw = dict(capacity=4, model_dtype=dtype, io_int16=True,
              frames_per_tick=2)
    outs = []
    for mesh in (None, ["cpu"], ["cpu", "cpu"]):
        srv = (StreamingServer(model, device="cpu", **kw) if mesh is None
               else StreamingServer(model, mesh=parallel.make_mesh(mesh),
                                    **kw))
        first = _serve(srv, pcm16, 4)
        srv.detach(3)                     # 2 shards: shard 1, slot 1
        assert srv.attach() == 3
        srv.submit(3, pcm16[3, :2 * C.FRAME_SIZE])
        again = srv.step()[3]
        assert again.dtype == np.int16
        # the re-attached slot starts from zero state: its tick is the
        # first tick of the same stream
        np.testing.assert_array_equal(again, first[3, :2 * C.FRAME_SIZE])
        outs.append(first)
    assert np.abs(outs[0]).max() > 1000
    np.testing.assert_array_equal(outs[1], outs[0])
    tol = {"f32": 2e-4, "bf16": 5e-3}[tier] * 32768
    assert np.abs(outs[2] - outs[0]).max() <= tol


def test_mesh_server_rejects_bad_meshes(weights):
    _, model = weights
    with pytest.raises(ValueError, match="does not divide"):
        StreamingServer(model, capacity=6,
                        mesh=parallel.make_mesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="not both"):
        StreamingServer(model, capacity=4, device="cpu",
                        mesh=parallel.make_mesh(["cpu"] * 2))


def test_batch_sharding_and_shard_batch():
    mesh = parallel.make_mesh(["cpu"] * 3)
    assert len(mesh) == 3 and parallel.DATA_AXIS == "dp"
    assert parallel.batch_sharding(mesh, 6) == [slice(0, 2), slice(2, 4),
                                                slice(4, 6)]
    assert parallel.replicated_sharding(mesh) == [slice(None)] * 3
    with pytest.raises(ValueError):
        parallel.batch_sharding(mesh, 7)
    x = np.arange(6 * 5, dtype=np.float32).reshape(6, 5)
    state = pipeline.init_pipeline_state(6, device="cpu")
    shards = parallel.shard_batch(mesh, {"x": x, "state": state})
    assert len(shards) == 3
    for i, sh in enumerate(shards):
        assert isinstance(sh["x"], torch.Tensor)
        np.testing.assert_array_equal(sh["x"].numpy(), x[2 * i:2 * i + 2])
        assert isinstance(sh["state"], pipeline.PipelineState)
        assert sh["state"].synthesis_mem.shape == (2, C.FRAME_SIZE)
        assert sh["state"].model.h1.shape[0] == 2
    # a shard is a copy: writing it leaves the batch alone
    shards[0]["x"][0, 0] = -1.0
    assert x[0, 0] == 0.0


def test_replicate_gives_one_copy_per_shard_even_on_a_repeated_device(
        weights):
    _, model = weights
    mesh = parallel.make_mesh(["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"), torch.device("cpu"))
    copies = parallel.replicate(mesh, model)
    assert len(copies) == 2 and copies[0] is not copies[1]
    for c in copies:
        for a, b in zip(c.parameters(), model.parameters()):
            assert a.data_ptr() != b.data_ptr()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    tree = {"w": torch.ones(3), "n": (np.zeros(2, np.float32),)}
    reps = parallel.replicate(mesh, tree)
    reps[0]["w"].add_(1.0)
    assert reps[1]["w"].tolist() == [1.0, 1.0, 1.0]
    assert tree["w"].tolist() == [1.0, 1.0, 1.0]
    assert isinstance(reps[1]["n"], tuple)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(["cuda", "cuda"])
    with pytest.raises(ValueError):
        parallel.make_mesh([])


def test_collectives_without_a_group_do_nothing():
    assert parallel.process_index() == 0
    assert parallel.process_count() == 1
    a, b = torch.tensor([1.0, 2.0]), torch.tensor(3.0)
    parallel.all_reduce_mean_([a, b])
    parallel.broadcast_([a, torch.tensor(True)])
    assert a.tolist() == [1.0, 2.0] and b.item() == 3.0
    with pytest.raises(ValueError, match="outside a world"):
        parallel.init_distributed("localhost:1", 2, 2, "cpu")


_GROUP_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from percepnet_tpu_torch import parallel
    coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dev = parallel.init_distributed(coord, 2, rank, "cpu")
    res = {"device": str(dev), "index": parallel.process_index(),
           "count": parallel.process_count()}
    g = [torch.full((2, 3), float(rank + 1)), torch.tensor(10.0 * rank)]
    parallel.all_reduce_mean_(g)
    res["mean"] = [g[0].tolist(), g[1].item()]
    b = [torch.full((3,), float(rank)), torch.tensor(rank == 0),
         torch.tensor(7 + rank, dtype=torch.int32)]
    parallel.broadcast_(b, src=0)
    res["bcast"] = [b[0].tolist(), bool(b[1]), int(b[2])]
    mesh = parallel.make_mesh(["cpu"])
    (local,) = parallel.shard_batch(mesh, np.full((2, 4), rank, np.float32))
    res["local"] = local.tolist()
    try:
        parallel.shard_batch(parallel.make_mesh(["cpu", "cpu"]),
                             np.zeros((2, 4), np.float32))
    except ValueError:
        res["two_device_mesh_refused"] = True
    parallel.mesh.barrier()
    parallel.mesh.shutdown()
    res["after"] = [parallel.process_index(), parallel.process_count()]
    json.dump(res, open(out, "w"))
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_collectives_in_a_two_process_gloo_group(tmp_path):
    """all_reduce_mean_ averages, broadcast_ takes rank 0's values (bool
    and int32 too), shard_batch keeps each rank's local batch, and the
    group is left cleanly."""
    coord = f"localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GROUP_SCRIPT, coord, str(r),
         str(tmp_path / f"r{r}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert res["device"] == "cpu"
        assert (res["index"], res["count"]) == (r, 2)
        assert res["mean"] == [[[1.5] * 3] * 2, 5.0]
        assert res["bcast"] == [[0.0] * 3, True, 7]
        assert res["local"] == [[float(r)] * 4] * 2
        assert res["two_device_mesh_refused"]
        assert res["after"] == [0, 1]
