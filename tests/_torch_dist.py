"""Spawned gloo ranks for the port's data- and tensor-parallel tests.

:func:`start_group` starts ``world`` processes with the ``spawn`` method,
joins them in one gloo process group through a ``file://`` store under the
caller's temporary directory and runs ``fn(rank, world, *args)`` on each
(one torch thread a rank); its :meth:`Group.result` returns the ranks'
results in rank order.  A rank that raises fails the call with its
traceback.  ``fn`` must be importable by its module path: the rank
functions live here, and import only torch and the port, so a spawned rank
loads no JAX.

:func:`run_launched` runs ``fn(rank, world, *args)`` the way ``torchrun``
would, with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and a ``MASTER_PORT``
on localhost in each rank's environment and no process group joined.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import socket
import traceback

import torch
import torch.multiprocessing as mp

TIMEOUT_S = 240


@dataclasses.dataclass(frozen=True)
class _Pickled:
    """Arguments passed through a file: a spawned child reads the pickled
    process object before it runs, and its parent's ``start`` blocks on a
    pipe until then, so large arguments would start the ranks one by one."""

    path: str

    def load(self):
        with open(self.path, "rb") as f:
            return pickle.load(f)


def _entry(rank, world, store, env, fn, args, queue):
    torch.set_num_threads(1)
    try:
        if isinstance(args, _Pickled):
            args = args.load()
        os.environ.update(env(rank) if env else {})
        if store:
            import torch.distributed as dist

            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            if store:
                dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


class Group:
    """Ranks started by :func:`start_group`; :meth:`result` waits for them."""

    def __init__(self, world, store, env, fn, args):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_entry, args=(r, world, store, env, fn, args, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self) -> list:
        """The ranks' results in rank order; a rank that raised fails the
        call with its traceback.  Collected once: a later call returns (or
        raises) the same."""
        if not hasattr(self, "_outcome"):
            try:
                self._outcome = (True, self._collect())
            except BaseException as e:  # noqa: BLE001 - re-raised below, and on every call
                self._outcome = (False, e)
        ok, value = self._outcome
        if not ok:
            raise value
        return value

    def close(self) -> None:
        """Collect the ranks (stopping any that hang) if nobody has."""
        try:
            self.result()
        except BaseException:  # noqa: BLE001 - a test that read the group reported it
            pass

    def _collect(self) -> list:
        got, failed = {}, []
        try:
            for _ in self.procs:
                rank, ok, out = self.queue.get(timeout=TIMEOUT_S)
                if not ok:
                    # Its peers may wait on it in a collective: stop them.
                    failed.append(f"rank {rank} failed:\n{out}")
                    break
                got[rank] = out
            if failed:
                raise AssertionError("\n".join(failed))
        finally:
            for p in self.procs:
                p.join(timeout=2 if failed else 30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        assert all(not p.is_alive() for p in self.procs)
        return [got[r] for r in range(len(self.procs))]


def start_group(fn, world: int, tmp_dir, *args) -> Group:
    """Starts the ranks and returns without waiting, so the caller can work
    (or start another group) while they run."""
    store = os.path.join(str(tmp_dir), f"store_{fn.__name__}_{world}")
    with open(f"{store}.args", "wb") as f:
        pickle.dump(args, f)
    return Group(world, store, None, fn, _Pickled(f"{store}.args"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass(frozen=True)
class _LaunchEnv:
    world: int
    port: int

    def __call__(self, rank):
        return {"RANK": str(rank), "WORLD_SIZE": str(self.world), "LOCAL_RANK": str(rank),
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(self.port)}


def run_launched(fn, world: int, *args):
    return Group(world, None, _LaunchEnv(world, _free_port()), fn, args).result()


@contextlib.contextmanager
def fp32_port_configs():
    """The port's ``get_config`` gives the fp32 variant of each arch."""
    import repro_torch.configs as tconfigs

    get = tconfigs.get_config
    tconfigs.get_config = lambda n: dataclasses.replace(get(n), dtype=torch.float32)
    try:
        yield
    finally:
        tconfigs.get_config = get


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_dist_ptq.py
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(a)


def tree_bits(tree) -> bytes:
    """Every tensor of a tree's bytes, in flatten order (a rank's fingerprint)."""
    from repro_torch.tree import tree_leaves

    return b"".join(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                    for t in tree_leaves(tree))


def ptq_rank(rank, world, case):
    """One rank of the sharded Σ, the row-sharded solves, qe_outlier under
    the mesh, qgather (two ranks), whole-model PTQ (two ranks) and a
    one-rank mesh (rank 0 of two ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import interop
    from repro_torch.core import solver
    from repro_torch.core.calib import CalibStats, sharded_gram
    from repro_torch.dist.collectives import block_bounds
    from repro_torch.dist.qgather import int8_rows, make_period_transform
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import model as M
    from repro_torch.quant import GridSpec

    mesh = make_data_mesh(device="cpu")
    assert mesh is not None and tuple(mesh.shape) == (world,)
    out = {}
    x = case["gram_x"]
    lo, hi = block_bounds(len(x), world, rank)
    out["gram"] = sharded_gram(_t(x[lo:hi]), mesh).numpy()
    xs = case["tokens_x"]  # (B, S, p): whole sequences per rank
    lo, hi = block_bounds(len(xs), world, rank)
    st = CalibStats.zeros(xs.shape[-1], device="cpu").update_tokens(_t(xs[lo:hi]), mesh=mesh)
    out["update_tokens"] = st.sigma.numpy()

    w3, s3 = _t(case["w3"]), _t(case["s3"])
    for method in ("quantease", "gptq", "rtn"):
        cfg = solver.PTQConfig(method=method, spec=GridSpec(bits=case["bits"]),
                               iterations=case["iterations"], shard=True)
        out[method] = solver._solve_group(w3, s3, cfg, mesh)[0].numpy()
    cfg = solver.PTQConfig(method="qe_outlier", spec=GridSpec(bits=case["bits"]),
                           iterations=case["iterations"], outlier_frac=0.05, shard=True)
    (wm, hm, _), (wl, hl, _) = (solver._solve_group(w3, s3, cfg, m) for m in (mesh, None))
    out["qe_outlier_bitwise"] = tree_bits([wm, hm]) == tree_bits([wl, hl])

    if world == 2:
        rules = make_rules(mesh, d_model=case["qg_d"], fsdp=True)
        axes = case["qg_axes"]
        leaves = {k: _t(v) for k, v in case["qg_leaves"].items()}
        if "qg_bf16" in case:
            leaves["bf16"] = _t(case["qg_bf16"]).to(torch.bfloat16)
        mine = {k: v if rules.shard_dim(axes[k]) is None
                else v.chunk(world, rules.shard_dim(axes[k]))[rank] for k, v in leaves.items()}
        got = make_period_transform(axes, rules, make_rules(mesh))(mine)
        out["qgather"] = {k: v.to(torch.float32).numpy() for k, v in got.items()}
        out["qgather_dtypes"] = {k: str(v.dtype) for k, v in got.items()}
        codes = {}
        for k, v in mine.items():
            if v.dim() >= 2:
                dim = rules.shard_dim(axes[k])
                c, s = int8_rows(v, mesh, dim)
                codes[k] = (c.numpy(), s.numpy(), dim)
        out["qgather_codes"] = codes

        plan = M.make_plan(case["cfg"])
        params = interop.params_from_jax(case["params"], device="cpu")
        pcfg = solver.PTQConfig(method="quantease", spec=GridSpec(bits=4),
                                iterations=case["iterations"], shard=True)
        records = []
        new, report = solver.ptq_quantize_model(plan, params, case["calib"], pcfg,
                                                progress_cb=records.append, mesh=mesh,
                                                device="cpu")
        out["report"], out["records"] = report, records
        out["ptq_bits"] = tree_bits(new)
        # A one-rank mesh over rank 0: the local path, bit for bit.
        one = DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("data",))
        if rank == 0:
            local = solver.ptq_quantize_model(plan, params, case["calib"], pcfg, device="cpu")
            mesh1 = solver.ptq_quantize_model(plan, params, case["calib"], pcfg, mesh=one,
                                              device="cpu")
            g1 = sharded_gram(_t(x), one)
            out["one_rank_bitwise"] = (tree_bits(local[0]) == tree_bits(mesh1[0])
                                       and local[1] == mesh1[1]
                                       and tree_bits(g1) == tree_bits(_t(x).T @ _t(x)))
        dist.barrier()
    if world == 3:
        out["elastic"] = _elastic()
        # Every rank past the meshes' subgroup handshakes before any rank
        # tears its process group down (a peer still connecting saw
        # "Connection closed by peer").
        dist.barrier()
    return out


def quantize_cli_rank(rank, world, argv):
    """``repro_torch.launch.quantize.main(argv)`` on one launched rank, with
    the port's configs at fp32."""
    from repro_torch.launch import quantize

    with fp32_port_configs():
        out = quantize.main(list(argv))
    return {k: v for k, v in out.items() if k != "out_dir"}


def _elastic():
    from repro_torch.dist.elastic import elastic_mesh

    mesh = elastic_mesh(2, device="cpu")
    try:
        elastic_mesh(4, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    coord = mesh.get_coordinate()
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.mesh.tolist(),
            None if coord is None else list(coord), refused)


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_dist_train.py
# ---------------------------------------------------------------------------


def _trainer(case, ckpt_dir, mesh, fsdp, moments):
    from repro_torch import interop
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    return Trainer(case["cfg"], AdamWConfig(moments=moments, **case["opt"]),
                   TrainerConfig(ckpt_dir=ckpt_dir, **case["tc"]), mesh=mesh, fsdp=fsdp,
                   params=interop.params_from_jax(case["params"], device="cpu"), device="cpu")


def train_rank(rank, world, case, root):
    """Each (fsdp, moments) run of ``case["runs"]`` on a data mesh over all
    ranks (losses; after the run, ``restore`` of the checkpoint it wrote
    must give back each rank's blocks bit for bit), then on rank 0 a
    one-rank mesh against ``mesh=None``, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.tree import tree_leaves

    mesh = make_data_mesh(device="cpu")
    out = {}
    for fsdp, moments in case["runs"]:
        tr = _trainer(case, os.path.join(root, f"{fsdp}_{moments}"), mesh, fsdp, moments)
        log = tr.run()["log"]
        before = tree_bits({"p": tr.params, "o": tr.opt_state})
        whole_params = tr._whole(tr.params, tr.shards)
        whole = tree_bits({"params": whole_params, "opt": tr._whole(tr.opt_state, tr.opt_shards)})
        step = tr.restore()
        out[(fsdp, moments)] = dict(
            losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
            whole=whole, params=[t.detach().numpy().copy() for t in tree_leaves(whole_params)],
            restored=step == case["tc"]["steps"]
            and tree_bits({"p": tr.params, "o": tr.opt_state}) == before,
            sharded=[d for d in (tr.shards.dims if tr.shards else ()) if d is not None])
    one = DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("data",))
    if rank == 0:
        same = []
        for fsdp, moments in case["runs"]:
            runs = []
            for m in (None, one):
                tr = _trainer(case, os.path.join(root, f"one_{m is None}_{fsdp}_{moments}"), m,
                              fsdp, moments)
                log = tr.run()["log"]
                runs.append(([(m["loss"], m["grad_norm"]) for m in log],
                             tree_bits({"p": tr.params, "o": tr.opt_state})))
            same.append(runs[0] == runs[1])
        out["one_rank_bitwise"] = same
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_tp.py
# ---------------------------------------------------------------------------


def storage_bytes(tree) -> dict:
    """``{path: bytes of the storage behind the leaf}`` of a params tree, a
    QuantizedTensor's array fields as ``path.field``: what a rank holds."""
    from repro_torch.quant import QuantizedTensor

    out = {}

    def walk(node, path):
        if isinstance(node, QuantizedTensor):
            for f in dataclasses.fields(node):
                t = getattr(node, f.name)
                if isinstance(t, torch.Tensor):
                    out[f"{path}.{f.name}"] = t.untyped_storage().nbytes()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        else:
            out[path] = node.untyped_storage().nbytes()

    walk(tree, "")
    return out


def tp_serve(plan, params, case, cache):
    """Prefill on a fresh contiguous cache, one decode step from ``cache``
    (the reference prefill's, or a rank's shard of it), then each engine
    on the case's prompts (logits recorded): what the tensor-parallel test
    compares, run the same way on one rank or on a model axis.  A case of
    the encoder-decoder or prefix family carries its frames or patches
    (``"inputs"``) and decodes after the prefix; with ``"greedy"`` steps it
    also returns its prefill's cross caches and a greedy run from that
    prefill's cache (the engines take token-only models)."""
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServingEngine, Request

    tokens = case["tokens"]
    pos = tokens.shape[1] + plan.cfg.n_prefix
    fresh = M.init_cache(plan, tokens.shape[0], case["cap"], device="cpu")
    l1, _ = M.prefill(plan, params, dict(case.get("inputs", {}), tokens=tokens), fresh)
    l2, cache = M.decode_step(plan, params, case["next"], cache, pos)
    # The cache entries the decode step wrote (bf16), one (k, v) per period
    # and attention block: (B, kv slots, hd).
    wrote = [(c["k"][i, :, pos].float().numpy(), c["v"][i, :, pos].float().numpy())
             for c in (cache[k] for k in sorted(cache)) if "k" in c
             for i in range(c["k"].shape[0])]
    out = {"prefill": l1.float().numpy(), "decode": l2.float().numpy(), "wrote": wrote}
    if case.get("greedy"):
        out["cross"] = [(c["ck"].float().numpy(), c["cv"].float().numpy())
                        for c in (fresh[k] for k in sorted(fresh)) if "ck" in c]
        out["greedy"] = greedy_run(plan, params, l1, fresh, pos, case["greedy"])
    for eng_name, kw in case["engines"].items():
        cls = PagedServingEngine if eng_name.startswith("paged") else _admissions()
        eplan = dataclasses.replace(plan, kv_cache_dtype="int8") if eng_name == "paged_int8" \
            else plan
        eng = cls(eplan, params, record_logits=True, device="cpu", **kw)
        for i, p in enumerate(case["prompts"]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=case["max_new"]))
        eng.run()
        out[eng_name] = ({r.rid: r.output for r in eng.finished}, eng.logit_trace)
        if eng_name == "contiguous":
            out[f"{eng_name}_admitted"] = eng.admitted
    return out


def greedy_run(plan, params, logits, cache, pos: int, steps: int) -> tuple:
    """``steps`` greedy decode steps after a prefill's ``logits`` and
    ``cache``, recorded as an engine records them: ``({row: tokens}, {row:
    [logits a step]})``, the prefill's logits and argmax first."""
    from repro_torch.models import model as M

    trace, tok = [logits.float().numpy()], logits.argmax(-1)
    out = [tok.numpy()]
    for j in range(steps):
        logits, cache = M.decode_step(plan, params, tok[:, None], cache, pos + j)
        tok = logits.argmax(-1)
        trace.append(logits.float().numpy())
        out.append(tok.numpy())
    rows = range(len(out[0]))
    return {b: [int(t[b]) for t in out] for b in rows}, {b: [l[b] for l in trace] for b in rows}


def _admissions():
    from repro_torch.serve import ServingEngine

    class Admissions(ServingEngine):
        """The contiguous engine, recording per request the bf16 Mamba
        convolution states its admission copied into the slot: the copy
        rounds an fp32 model's prefill state to the cache's bf16 (as the
        reference's engine does), where a state one fp32 ulp apart can land
        on the next bf16 value."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.admitted = {}

        def _admit(self):
            free = [r is None for r in self.slot_req]
            super()._admit()
            for slot, req in enumerate(self.slot_req):
                if free[slot] and req is not None:
                    self.admitted[req.rid] = {
                        (blk, k): t[:, slot].view(torch.int16).numpy().copy()
                        for blk, leaves in self.cache.items() for k, t in leaves.items()
                        if k in ("conv_x", "conv_bc") and t.dtype == torch.bfloat16}

    return Admissions



def tp_rank(rank, world, cases, root=None):
    """Every case of ``cases`` on a ("model",) mesh over all ranks: the
    whole params (dense or a serving artifact) cut by
    ``dist.sharding.shard_tree`` under ``serve.qparams.serving_rules``, then
    :func:`tp_serve` inside the rules; each case's storage bytes per leaf
    and collectives (the forward pass' all-reduce and all-gather calls and
    bytes, counted by wrapping ``dist.collectives.all_reduce`` and
    ``gather_dim``, through which the model's collectives run: over the
    whole case, and those of its decode step alone under ``"decode"``)
    come back with its
    outputs, with the MoE routers' top-k expert ids of every call
    (``"routes"``: their count and the digest of their bytes).  With
    ``root`` each rank also saves its local tree with
    ``dist.checkpoint.save_checkpoint`` under ``root`` and loads it back
    into that tree's form (``"ckpt"``: the same bits)."""
    import hashlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import axis_rules, shard_tree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.qparams import qt_param_axes, serving_rules

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("model",))
    comm, routes = {}, []

    def counted(kind, fn):
        def call(t, *a, **k):  # the bytes a rank sends: its tensor, or its shard
            row = comm[kind]
            row[0], row[1] = row[0] + 1, row[1] + t.numel() * t.element_size()
            return fn(t, *a, **k)
        return call

    def decode_counted(*a, **k):
        before = {kind: comm[kind][0] for kind in ("all_reduce", "all_gather")}
        out = originals["decode_step"](*a, **k)
        comm.setdefault("decode", {kind: comm[kind][0] - n for kind, n in before.items()})
        return out

    def routed(*a, **k):
        out = originals["_route"](*a, **k)
        routes.append(out[2].numpy().tobytes())
        return out

    originals = {"all_reduce": C.all_reduce, "gather_dim": C.gather_dim,
                 "decode_step": M.decode_step, "_route": moe._route}
    C.all_reduce = counted("all_reduce", originals["all_reduce"])
    C.gather_dim = counted("all_gather", originals["gather_dim"])
    M.decode_step, moe._route = decode_counted, routed
    out = {}
    try:
        for name, case in cases.items():
            plan = M.make_plan(case["cfg"], world)
            rules = serving_rules(plan, mesh)
            axes = qt_param_axes(plan, case["params"]) if case["quantized"] else M.param_axes(plan)
            local = shard_tree(case["params"], axes, rules)
            cache = shard_tree(case["cache"], M.cache_axes(plan), rules)
            comm.clear()
            comm.update(all_reduce=[0, 0], all_gather=[0, 0])
            routes.clear()
            with axis_rules(rules):
                res = tp_serve(plan, local, case, cache)
            res["bytes"] = storage_bytes(local)
            res["comm"] = {k: (dict(v) if k == "decode" else list(v)) for k, v in comm.items()}
            res["routes"] = (len(routes), hashlib.sha256(b"".join(routes)).hexdigest())
            if root is not None:
                from repro_torch.dist import checkpoint as ckpt

                d = os.path.join(root, f"{name}_{rank}")
                ckpt.save_checkpoint(d, 0, local)
                res["ckpt"] = tree_bits(ckpt.load_checkpoint(d, local)[0]) == tree_bits(local)
            out[name] = res
    finally:
        C.all_reduce, C.gather_dim = originals["all_reduce"], originals["gather_dim"]
        M.decode_step, moe._route = originals["decode_step"], originals["_route"]
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_tp_train.py
# ---------------------------------------------------------------------------


def collective_inputs(world: int, rank: int) -> dict:
    """The seeded fp32 inputs of :func:`collectives_rank` on one rank: ``x``
    (the same on every rank), ``w`` (the rank's own), ``part`` (the rank's
    shard or partial), ``v`` (the same on every rank, gathered shape)."""
    import numpy as np

    same, own = np.random.default_rng(7), np.random.default_rng(100 + rank)
    return dict(x=same.standard_normal((3, 4)).astype(np.float32),
                v=same.standard_normal((3, 4 * world)).astype(np.float32),
                w=own.standard_normal((3, 4 * world)).astype(np.float32),
                part=own.standard_normal((3, 4)).astype(np.float32))


def collectives_rank(mesh, world: int, rank: int) -> dict:
    """Each collective of ``dist.collectives`` on the mesh's "model" dim,
    forward and backward: ``{name: (forward, gradient of the input)}``."""
    from repro_torch.dist import collectives as C

    a = {k: torch.from_numpy(v) for k, v in collective_inputs(world, rank).items()}
    out = {}

    def run(name, fn, t, use):
        t = t.clone().requires_grad_(True)
        y = fn(t)
        use(y).backward()
        out[name] = (y.detach().numpy().copy(), t.grad.numpy().copy())

    xw = a["x"].repeat(1, world)  # (3, 4·world): x entering the rank's own work w
    run("copy_to", lambda t: C.copy_to(t, mesh, "model"), xw, lambda y: (y * a["w"]).sum())
    run("reduce_from", lambda t: C.reduce_from(t, mesh, "model"), a["w"],
        lambda y: (y * a["v"]).sum())
    run("gather_from", lambda t: C.gather_from(t, -1, mesh, "model"), a["part"],
        lambda y: (y * a["v"]).sum())
    run("gather_dim_grad", lambda t: C.gather_dim_grad(t, 1, mesh, "model"), a["part"],
        lambda y: (y * a["w"]).sum())
    m = C.max_over(a["w"].requires_grad_(True), mesh, "model")
    out["max_over"] = (m.numpy().copy(), m.requires_grad)
    with torch.no_grad():
        out["no_grad_bits"] = {
            "copy_to": tree_bits([C.copy_to(xw, mesh, "model")]) == tree_bits([xw]),
            "reduce_from": tree_bits([C.reduce_from(a["w"], mesh, "model")])
            == tree_bits([C.all_reduce(a["w"].clone(), mesh, "model")]),
            "gather_from": tree_bits([C.gather_from(a["part"], -1, mesh, "model")])
            == tree_bits([C.gather_dim(a["part"], -1, mesh, "model")])}
    return out


def _model_peers_bits(tree, shards) -> bytes:
    """The bits of the leaves every rank of the "model" dim holds whole."""
    from repro_torch.tree import tree_leaves

    return tree_bits([t for t, d in zip(tree_leaves(tree), shards.model_dims) if d is None])


def _tp_trainer(case, ckpt_dir, mesh, **tc):
    from repro_torch import interop
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    return Trainer(case["cfg"], AdamWConfig(moments=case["moments"], **case["opt"]),
                   TrainerConfig(ckpt_dir=ckpt_dir, **dict(case["tc"], **tc)), mesh=mesh,
                   fsdp=case["fsdp"], params=interop.params_from_jax(case["params"], device="cpu"),
                   device="cpu", dispatch_groups=case.get("dispatch_groups", 1))


def tp_train_rank(rank, world, cases, root, dims):
    """Every case of ``cases`` trained by ``Trainer(mesh=)`` on a mesh of
    ``dims`` (("model",), or ("data", "model") of 2 × 2) over all ranks: the
    step-1 loss and gathered gradients (``loss_and_grads`` inside the
    trainer's rules), each step's loss and gradient norm, the bits of the
    leaves whole on "model" before each step and after the run, the whole
    final params and state the ranks gather, whether ``restore`` of the
    checkpoint the run wrote gives back each rank's blocks bit for bit, and
    for a case with ``"resume"`` whether a run stopped after
    ``resume`` steps and resumed ends with the uninterrupted run's bits.
    On a ("model",) mesh also :func:`collectives_rank`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import axis_rules
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import tree_leaves

    shape = (2, world // 2) if len(dims) == 2 else (world,)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=dims)
    out = {"collectives": collectives_rank(mesh, world, rank)} if dims == ("model",) else {}
    for label, case in cases.items():
        tr = _tp_trainer(case, os.path.join(root, label), mesh)
        batch = tr._put_batch(tr.batch_fn(0))
        with axis_rules(tr.rules):
            loss1, grads = loss_and_grads(tr.plan, tr.params, batch, tr.tcfg.n_microbatches,
                                          tr.shards)
        grads = tr._whole(grads, tr.shards)
        peers = []
        log = tr.run(fault_hook=lambda step: peers.append(_model_peers_bits(tr.params,
                                                                              tr.shards)))["log"]
        peers.append(_model_peers_bits(tr.params, tr.shards))
        before = tree_bits({"p": tr.params, "o": tr.opt_state})
        params = tr._whole(tr.params, tr.shards)
        whole = tree_bits({"params": params, "opt": tr._whole(tr.opt_state, tr.opt_shards)})
        res = dict(losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
                   loss1=float(loss1), grads=[g.numpy().copy() for g in tree_leaves(grads)],
                   params=[t.numpy().copy() for t in tree_leaves(params)], whole=whole,
                   peers=peers, coord=tuple(mesh.get_coordinate()),
                   sharded={a: [d for d in ds if d is not None] for a, ds in tr.shards.cuts()})
        res["restored"] = (tr.restore() == case["tc"]["steps"]
                           and tree_bits({"p": tr.params, "o": tr.opt_state}) == before)
        if case.get("resume"):
            d = os.path.join(root, f"{label}_resume")
            _tp_trainer(case, d, mesh, steps=case["resume"], ckpt_every=case["resume"]).run()
            again = _tp_trainer(case, d, mesh, ckpt_every=case["tc"]["steps"] + 1)
            again.run()
            res["resumed"] = tree_bits({"p": again.params, "o": again.opt_state}) == before
        out[label] = res
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_tp_spec.py
# ---------------------------------------------------------------------------


class StepClock:
    """A deterministic engine clock: each call advances one virtual second
    (``tests/test_torch_paged_engine.py``'s)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


class SkewedClock:
    """A clock far from rank 0's and running faster: 1,000 s ahead of the
    host's monotonic clock at three times its rate; ``reads`` counts the
    calls."""

    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        import time

        self.reads += 1
        return 1e3 + 3.0 * time.monotonic()


class _PoolLog:
    """Every allocation and release of a page pool, in order."""

    def __init__(self, pool):
        self.ops = []
        alloc, release = pool.alloc, pool.release

        def logged_alloc(n):
            got = alloc(n)
            self.ops.append(("alloc", n, None if got is None else tuple(got)))
            return got

        def logged_release(p):
            self.ops.append(("release", p))
            return release(p)

        pool.alloc, pool.release = logged_alloc, logged_release


def _error_kind(error):
    if error is None:
        return None
    for kind in ("provably unmeetable", "unsatisfiable"):
        if kind in error:
            return kind
    return error


def tp_spec_serve(plan, params, case, rules=None, draft=None):
    """One engine run of a ``tests/test_torch_tp_spec.py`` case: the paged
    engine (with ``draft``, a ``(plan, params)`` pair, speculative at the
    case's γ) or the contiguous one, on the case's clock (``"step"``: a
    :class:`StepClock` on rank 0 of ``rules``' mesh, or without rules, and
    a :class:`SkewedClock` elsewhere), serving the case's waves of requests
    one ``run()`` after another.  Returns every request's output, status,
    error kind, counters and timestamps, the engine's counters, its logits
    a step, the pool's free pages and the digest of its allocations and
    releases, the clock readings it took and the skewed clock's own."""
    import hashlib

    from repro_torch.dist.collectives import axis_rank
    from repro_torch.serve import PagedServingEngine, Request, ServingEngine
    from repro_torch.serve.spec import SpecConfig

    clock = None
    if case["clock"] == "step":
        lead = rules is None or axis_rank(rules.mesh, "model") == 0
        clock = StepClock() if lead else SkewedClock()
    if case["engine"] == "contiguous":
        eng = ServingEngine(plan, params, record_logits=True, clock=clock, device="cpu",
                            **case["kw"])
        log = None
    else:
        spec = None if draft is None else SpecConfig(*draft, gamma=case["gamma"])
        eng = PagedServingEngine(plan, params, spec=spec, record_logits=True, clock=clock,
                                 device="cpu", **case["kw"])
        log = _PoolLog(eng.pool)
    proposals = []
    if getattr(eng, "spec_mgr", None) is not None:
        propose = eng.spec_mgr.propose

        def recorded(items):  # the draft's proposals, before the verify trims any
            got = propose(items)
            proposals.append(sorted(got.items()))
            return got

        eng.spec_mgr.propose = recorded
    reqs = []
    for wave in case["waves"]:
        for r in wave:
            req = Request(rid=r["rid"], prompt=r["prompt"], max_new_tokens=r["max_new"],
                          deadline_ms=r.get("deadline_ms"), priority=r.get("priority", 0))
            eng.submit(req)
            reqs.append(req)
        eng.run()
    out = {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "requests": {r.rid: dict(status=r.status, error=_error_kind(r.error),
                                 n_preemptions=r.n_preemptions, n_spec_rounds=r.n_spec_rounds,
                                 n_draft_tokens=r.n_draft_tokens,
                                 n_draft_accepted=r.n_draft_accepted, submit_t=r.submit_t,
                                 first_token_t=r.first_token_t, finish_t=r.finish_t)
                     for r in reqs},
        "trace": {rid: [l.copy() for l in ls] for rid, ls in eng.logit_trace.items()},
        "counters": {k: getattr(eng, k, None) for k in (
            "n_decode_steps", "n_shed", "n_deadline_missed", "n_preemptions", "n_spec_rounds",
            "n_draft_tokens", "n_draft_accepted")},
        "clock_reads": getattr(eng.clock, "n_reads", None),
        "clock_broadcasts": getattr(eng.clock, "n_broadcasts", None),
        "own_clock_reads": clock.reads if isinstance(clock, SkewedClock) else None,
    }
    if log is not None:
        out["proposals"] = hashlib.sha256(repr(proposals).encode()).hexdigest()
        out["free"] = (eng.pool.n_free, eng.n_pages - 1)
        out["pool_log"] = hashlib.sha256(repr(log.ops).encode()).hexdigest()
        out["pool_ops"] = len(log.ops)
    return out


def tp_spec_rank(rank, world, cases):
    """Every case of ``cases`` on a ("model",) mesh over all ranks: the
    whole params cut by ``dist.sharding.shard_tree`` under
    ``serve.qparams.serving_rules``, the draft the truncation of the rank's
    local params or its shard of the case's RTN artifact, then
    :func:`tp_spec_serve` inside the rules, with the collectives of the run
    counted per kind (the broadcasts of the agreed clock among them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import axis_rules, shard_tree
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import qt_param_axes, serving_rules
    from repro_torch.serve.spec import truncate_draft

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("model",))
    out = {"broadcast": C.broadcast_from([rank + 0.25 + 1e-12, rank - 3.5], mesh)}
    comm = {}

    def counted(kind, fn):
        def call(*a, **k):
            comm[kind] = comm.get(kind, 0) + 1
            return fn(*a, **k)
        return call

    originals = {"all_reduce": C.all_reduce, "gather_dim": C.gather_dim,
                 "broadcast_from": C.broadcast_from}
    for name, fn in originals.items():
        setattr(C, name, counted(name, fn))
    try:
        for name, case in cases.items():
            plan = M.make_plan(case["cfg"], world)
            rules = serving_rules(plan, mesh)
            local = shard_tree(case["params"], M.param_axes(plan), rules)
            draft = None
            if case.get("draft") == "truncate":
                draft = truncate_draft(plan, local, 1)
            elif case.get("draft") == "rtn":
                draft = (plan, shard_tree(case["rtn"], qt_param_axes(plan, case["rtn"]), rules))
            comm.clear()
            with axis_rules(rules):
                res = tp_spec_serve(plan, local, case, rules, draft)
            res["comm"] = dict(comm)
            out[name] = res
    finally:
        for name, fn in originals.items():
            setattr(C, name, fn)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_moe_groups.py
# ---------------------------------------------------------------------------


def moe_groups_rank(rank, world, cases, root):
    """Each case of ``cases`` trained by :func:`tp_train_rank` on a
    ("data", "model") mesh of 2 × 2, one at a time, with the all-gathers
    over "data" of integer tensors (the MoE routers' top-k ids, the only
    such gather) counted per case under ``"id_gathers"``."""
    from repro_torch.dist import collectives as C

    gather = C.gather_dim
    counts = {"n": 0}

    def counted(t, dim, mesh, axis="data"):
        if axis == "data" and not t.is_floating_point():
            counts["n"] += 1
        return gather(t, dim, mesh, axis)

    C.gather_dim = counted
    out = {}
    try:
        for label, case in cases.items():
            counts["n"] = 0
            out[label] = tp_train_rank(rank, world, {label: case}, root, ("data", "model"))[label]
            out[label]["id_gathers"] = counts["n"]
    finally:
        C.gather_dim = gather
    return out
