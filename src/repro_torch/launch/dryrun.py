"""Dry run of the production cells: for every (architecture x input shape x
mesh), build the step function, its example inputs on the ``meta`` device
(shapes and dtypes, nothing allocated), the rule table of `rules_for` and
each argument's sharding on the production mesh, and record what follows
from them without a compiler: the parameter count, the analytic per-chip
FLOPs and bytes (`launch.flops.cell_costs`) and the bytes of the arguments
each device holds. Counterpart of `repro.launch.dryrun` without its
XLA-only part: the reference lowers and compiles each cell for a 512-device
mesh forced onto the host and reads XLA's memory and cost analyses and the
collectives of the compiled HLO, which PyTorch has no counterpart for.

Results are cached as JSON per cell under --out (default
build/dryrun_results/).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun_results
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback

import torch

from repro_torch.configs.registry import ARCH_IDS, SHAPES, cell_supported, get_config, input_specs
from repro_torch.distributed.sharding import Rules, is_axes, rules_for
from repro_torch.launch.flops import cell_costs
from repro_torch.models import decode_step, forward
from repro_torch.tree import tree_leaves
from repro_torch.models.transformer import decode_state_axes, init_params, param_axes
from repro_torch.train import TrainConfig, init_train_state, make_train_step

# the production meshes (the reference's `launch/mesh.py`), axis -> size
MESHES = {False: ("pod16x16", {"data": 16, "model": 16}),
          True: ("pod2x16x16", {"pod": 2, "data": 16, "model": 16})}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """An argument's placement: its spec (`Rules.spec`'s form) on a mesh
    of ``{axis name: size}``. Counterpart of `jax.sharding.NamedSharding`."""

    mesh: dict
    spec: tuple

    def ways(self, m) -> int:
        """Shards along one spec entry."""
        if m is None:
            return 1
        return self.mesh[m] if isinstance(m, str) else math.prod(self.mesh[a] for a in m)

    def device_bytes(self, t) -> int:
        """Bytes of ``t``'s shard on one device."""
        return t.numel() * t.element_size() // math.prod(self.ways(m) for m in self.spec)


def _shardings(tree_axes, tree_shapes, rules: Rules, mesh: dict):
    """Logical axes -> each argument's `NamedSharding`. An argument's dims
    must divide evenly (unlike internal constraints), so a dim whose size
    the mesh axes' product does not divide is replicated, for the argument
    only."""

    def one(axes, shp):
        sh = NamedSharding(mesh, rules.spec(axes))
        return NamedSharding(mesh, tuple(m if n % sh.ways(m) == 0 else None for m, n in zip(sh.spec, shp.shape)))

    def walk(axes, shapes):
        if is_axes(axes):
            return one(axes, shapes)
        if isinstance(axes, dict):
            return {k: walk(v, shapes[k]) for k, v in axes.items()}
        return tuple(walk(a, t) for a, t in zip(axes, shapes, strict=True))

    return walk(tree_axes, tree_shapes)


def _batch_axes(specs: dict) -> dict:
    out = {}
    for k in specs:
        if k in ("inputs", "targets", "tokens", "mask"):
            out[k] = ("batch", None)
        elif k in ("frames", "prefix_embeddings", "enc_out"):
            out[k] = ("batch", None, None)
        else:
            raise KeyError(k)
    return out


def build_cell(arch: str, shape_name: str, *, multi_pod: bool):
    """Returns (fn, example args on ``meta``, their shardings, rules, mesh
    sizes, cfg)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = MESHES[multi_pod][1]
    data_size = 16 * (2 if multi_pod else 1)
    shard_batch = shape.global_batch % data_size == 0

    mode = "train" if shape.kind == "train" else "decode"
    rules = Rules(rules_for(cfg, mode=mode, multi_pod=multi_pod, shard_batch=shard_batch), mesh)
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        # 4-way gradient accumulation everywhere, as in the reference
        train_step = make_train_step(cfg, TrainConfig(microbatches=4))
        state = init_train_state(None, cfg, device="meta")
        pax = param_axes(cfg)
        state_axes = {"params": pax, "opt": {"mu": pax, "nu": pax, "count": ()}, "step": ()}
        in_shardings = (_shardings(state_axes, state, rules, mesh),
                        _shardings(_batch_axes(specs), specs, rules, mesh))
        return train_step, (state, specs), in_shardings, rules, mesh, cfg

    params = init_params(None, cfg, device="meta")
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            kwargs = {k: batch[k] for k in ("frames", "prefix_embeddings") if k in batch}
            logits = forward(params, batch["inputs"], cfg, remat=False, **kwargs)
            return logits[:, -1, :]  # next-token logits (cache write covered by decode cells)

        in_shardings = (_shardings(param_axes(cfg), params, rules, mesh),
                        _shardings(_batch_axes(specs), specs, rules, mesh))
        return prefill_step, (params, specs), in_shardings, rules, mesh, cfg

    def serve_step(params, state, batch):
        logits, new_state = decode_step(params, state, batch["tokens"], cfg, enc_out=batch.get("enc_out"))
        return torch.argmax(logits[:, -1], dim=-1), new_state

    state_specs = specs["state"]
    batch_specs = {k: v for k, v in specs.items() if k != "state"}
    in_shardings = (_shardings(param_axes(cfg), params, rules, mesh),
                    _shardings(decode_state_axes(cfg), state_specs, rules, mesh),
                    _shardings(_batch_axes(batch_specs), batch_specs, rules, mesh))
    return serve_step, (params, state_specs, batch_specs), in_shardings, rules, mesh, cfg


def run_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    mesh_name = MESHES[multi_pod][0]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    supported, reason = cell_supported(arch, shape_name)
    if not supported:
        record["skipped"] = reason
        return record

    _, args, in_shardings, _, mesh, cfg = build_cell(arch, shape_name, multi_pod=multi_pod)
    record["params_b"] = cfg.param_count() / 1e9
    # XLA's memory_analysis counts the same buffers: every argument's shard
    record["argument_size_in_bytes"] = sum(
        sh.device_bytes(t) for t, sh in zip(tree_leaves(args), tree_leaves(in_shardings), strict=True))
    chips = math.prod(mesh.values())
    analytic = cell_costs(cfg, SHAPES[shape_name], chips)
    record["flops"] = analytic["flops"]            # per chip, loop-corrected
    record["bytes_accessed"] = analytic["bytes"]   # per chip, loop-corrected
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun_results")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                mesh_name = MESHES[multi_pod][0]
                path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {path}")
                    continue
                try:
                    record = run_cell(arch, shape_name, multi_pod=multi_pod)
                except Exception as exc:  # noqa: BLE001 — record failures, keep sweeping
                    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                              "error": f"{type(exc).__name__}: {exc}", "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(record, f, indent=1)
                status = "SKIP" if "skipped" in record else ("FAIL" if "error" in record else "ok")
                line = f"[{status}] {arch} x {shape_name} x {mesh_name}"
                if status == "ok":
                    line += (f" args={record['argument_size_in_bytes'] / 2**30:.3f}GB/device "
                             f"flops={record['flops']:.4g}/chip bytes={record['bytes_accessed']:.4g}/chip")
                print(line + " " + record.get("error", record.get("skipped", ""))[:120], flush=True)

if __name__ == "__main__":
    main()
