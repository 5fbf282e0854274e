"""CLI: train / eval / render entry points (mirror of
``neusky_tpu/cli.py``).  Methods are looked up in the registry
(``configs/registry.py``) and any config leaf is overridable with dotted
``--path.to.field value`` flags (dataclass trees are rebuilt immutably).
``--device`` (default ``cuda``) picks the device; without a card the
default raises, and ``--device cpu`` runs on the CPU.

Usage:
    python -m neusky_torch.cli train neusky --data /path/to/nerfosr --scene site1
    python -m neusky_torch.cli train neusky-synthetic --data /path/to/blender_scene
    python -m neusky_torch.cli train neusky-tiny --synthetic-demo --device cpu
    python -m neusky_torch.cli eval  neusky --data ... --load-dir outputs/run
    python -m neusky_torch.cli render neusky --data ... --load-dir outputs/run --output out.npy
    python -m neusky_torch.cli train ddf --data ... --load-dir outputs/run --output-dir outputs/ddf
    python -m neusky_torch.cli eval  neusky --data ... --load-dir outputs/run --protocol nerfosr --output m.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict


def _set_dotted(obj: Any, dotted: str, value: str) -> Any:
    """Immutably set a dotted-path field on a (frozen) dataclass tree."""
    head, _, rest = dotted.partition(".")
    if not dataclasses.is_dataclass(obj):
        raise ValueError(f"cannot descend into {type(obj)} at {dotted}")
    current = getattr(obj, head)
    if rest:
        new_val = _set_dotted(current, rest, value)
    else:
        # cast to the existing field's type
        if isinstance(current, bool):
            new_val = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            new_val = int(value)
        elif isinstance(current, float):
            new_val = float(value)
        elif isinstance(current, str):
            new_val = value
        else:
            new_val = json.loads(value)
    return dataclasses.replace(obj, **{head: new_val})


def _apply_overrides(bundle: Dict[str, Any], overrides: list) -> Dict[str, Any]:
    key_map = {"model": "model_config", "pipeline": "pipeline_config", "trainer": "trainer_config"}
    for dotted, value in overrides:
        root, _, rest = dotted.partition(".")
        key = key_map.get(root, root)
        if key not in bundle:
            raise KeyError(f"unknown config root '{root}' (have {list(bundle)})")
        if rest:
            bundle[key] = _set_dotted(bundle[key], rest, value)
        else:
            bundle[key] = json.loads(value)
    return bundle


def _build_datamanager(args, model_config, dataparser: str = "nerfosr"):
    """The run's ``DataManager`` on ``args.device``: the synthetic sphere
    scene (``--synthetic-demo`` or no ``--data``), else the train and
    validation splits of ``args.data`` through the method's dataparser,
    ``nerfosr`` or ``custom_neusky`` (Blender-synthetic).  A batch is U =
    min(16, train images) images × ``rays_per_batch // U`` rays."""
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig

    if args.synthetic_demo or args.data is None:
        from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene

        scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=model_config.num_train_data))
        u = min(8, model_config.num_train_data)
        return DataManager(
            DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=u,
                                                               rays_per_image=args.rays_per_batch // u)),
            scene["cameras"], scene["images"], scene["masks"], device=args.device,
        )

    from neusky_torch.data.dataset import NeuSkyDataset

    if dataparser == "custom_neusky":
        from neusky_torch.data.dataparsers.custom_synthetic import (
            CustomSyntheticDataparserConfig,
            parse_custom_synthetic_scene,
        )

        parser_cfg = CustomSyntheticDataparserConfig(data=args.data)
        train_po = parse_custom_synthetic_scene(parser_cfg, "train")
        val_po = parse_custom_synthetic_scene(parser_cfg, "val")
    else:
        from neusky_torch.data.dataparsers.nerfosr import (
            NeRFOSRDataparserConfig,
            parse_holdout_arg,
            parse_nerfosr_scene,
        )

        parser_cfg = NeRFOSRDataparserConfig(
            data=args.data, scene=args.scene,
            session_holdout_indices=parse_holdout_arg(getattr(args, "session_holdout_indices", "0,0,0,0,0")),
        )
        train_po = parse_nerfosr_scene(parser_cfg, "train")
        val_po = parse_nerfosr_scene(parser_cfg, "validation")
    train_data = NeuSkyDataset(train_po, "train", args.downscale).load()
    val_data = NeuSkyDataset(val_po, "val", args.downscale).load()
    u = min(16, train_data["images"].shape[0])
    return DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=u, rays_per_image=args.rays_per_batch // u)),
        train_data["cameras"], train_data["images"], train_data["masks"],
        val_data["cameras"], val_data["images"], val_data["masks"],
        device=args.device,
    )


def print_record(record: Dict[str, Any]) -> None:
    """The training log line: one JSON object a logged step."""
    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in record.items()}), flush=True)


def cmd_train(args, overrides):
    from neusky_torch.configs import METHOD_REGISTRY
    from neusky_torch.engine.trainer import Trainer
    from neusky_torch.models.neusky import NeuSkyModel

    if args.method == "ddf":
        return _cmd_train_ddf(args, overrides)
    bundle = _apply_overrides(METHOD_REGISTRY[args.method].build(), overrides)
    model_config = bundle["model_config"]
    dm = _build_datamanager(args, model_config, bundle.get("dataparser", "nerfosr"))
    # align latent counts with the data
    model_config = dataclasses.replace(model_config, num_train_data=dm.num_train, num_eval_data=max(dm.num_eval, 1))
    model = NeuSkyModel(model_config, device=args.device)
    trainer_config = bundle["trainer_config"]
    if args.max_iterations:
        trainer_config = dataclasses.replace(trainer_config, max_num_iterations=args.max_iterations)
    trainer_config = dataclasses.replace(trainer_config, output_dir=args.output_dir)
    trainer = Trainer(trainer_config, model, bundle["pipeline_config"], dm,
                      optimizer_groups=bundle.get("optimizer_groups"), device=args.device,
                      graphed=False if args.eager else None)
    if args.load_dir:
        trainer.load(args.load_dir)
    trainer.run(log_fn=print_record)
    trainer.save()
    print(f"done — checkpoints in {trainer_config.output_dir}")


def _cmd_train_ddf(args, overrides):
    """``train ddf``: the DDF fitted alone against the frozen NeuSky
    checkpoint under ``--load-dir`` (scene method ``neusky-tiny`` with
    ``--synthetic-demo``, else ``neusky``; the ``ddf`` recipe's sampler and
    iteration count); the merged params with the trained DDF are saved under
    ``--output-dir``."""
    from pathlib import Path

    import torch

    from neusky_torch.configs import METHOD_REGISTRY
    from neusky_torch.device import resolve_device
    from neusky_torch.engine.checkpoint import load_param_subtrees, save_checkpoint
    from neusky_torch.engine.ddf_trainer import DDFTrainer, DDFTrainerConfig
    from neusky_torch.models.neusky import NeuSkyModel

    if not args.load_dir:
        raise SystemExit("ddf training requires --load-dir (frozen NeuSky ckpt)")
    scene_method = "neusky-tiny" if args.synthetic_demo else "neusky"
    bundle = _apply_overrides(METHOD_REGISTRY[scene_method].build(), overrides)
    model_config = bundle["model_config"]
    dm = _build_datamanager(args, model_config)
    model_config = dataclasses.replace(model_config, num_train_data=dm.num_train, num_eval_data=max(dm.num_eval, 1))
    model = NeuSkyModel(model_config, device=args.device)
    params = model.init(torch.Generator(device=resolve_device(args.device)).manual_seed(0))
    params = load_param_subtrees(Path(args.load_dir), None, params)  # full restore
    ddf_bundle = METHOD_REGISTRY["ddf"].build()
    tcfg = DDFTrainerConfig(
        max_num_iterations=args.max_iterations or ddf_bundle["trainer_config"].max_num_iterations,
        sampler=ddf_bundle["sampler_config"],
    )
    trainer = DDFTrainer(tcfg, model, params, datamanager=dm, graphed=False if args.eager else None)
    trainer.run(log_fn=print_record)
    params["ddf_field"] = trainer.ddf_params
    save_checkpoint(Path(args.output_dir), trainer.step, params, {})
    print(f"done — DDF checkpoint in {args.output_dir}")


def cmd_eval(args, overrides):
    if getattr(args, "protocol", None) == "nerfosr":
        from neusky_torch.engine.eval_loop import run_nerfosr_eval

        return run_nerfosr_eval(args, overrides)
    from neusky_torch.engine.eval_loop import run_eval

    run_eval(args, overrides)


def cmd_render(args, overrides):
    from neusky_torch.engine.eval_loop import run_render

    run_render(args, overrides)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="neusky-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("train", "eval", "render"):
        p = sub.add_parser(name)
        p.add_argument("method", help="method name (neusky, neusky-synthetic, neusky-tiny, ...)")
        p.add_argument("--data", default=None)
        p.add_argument("--scene", default="site1")
        p.add_argument("--downscale", type=int, default=1)
        p.add_argument("--rays-per-batch", type=int, default=1024)
        p.add_argument("--output-dir", default="outputs/run")
        p.add_argument("--load-dir", default=None)
        p.add_argument("--max-iterations", type=int, default=None)
        p.add_argument("--synthetic-demo", action="store_true",
                       help="train on the built-in synthetic sphere scene")
        p.add_argument("--output", default="render.npy")
        p.add_argument("--image-idx", type=int, default=0)
        p.add_argument("--protocol", default=None, choices=(None, "nerfosr"),
                       help="eval: the NeRF-OSR session-holdout relighting benchmark (metrics JSON)")
        p.add_argument("--session-holdout-indices", default="0,0,0,0,0",
                       help="comma-separated per-session holdout image indices; length must equal the "
                       "scene's session count")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.add_argument("--eager", action="store_true",
                       help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")

    args, unknown = parser.parse_known_args(argv)
    overrides = []
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if tok.startswith("--") and i + 1 < len(unknown):
            overrides.append((tok[2:], unknown[i + 1]))
            i += 2
        else:
            raise SystemExit(f"unparsed argument: {tok}")

    if args.command == "train":
        cmd_train(args, overrides)
    elif args.command == "eval":
        cmd_eval(args, overrides)
    elif args.command == "render":
        cmd_render(args, overrides)


def train_entry():
    main(["train"] + sys.argv[1:])


def eval_entry():
    main(["eval"] + sys.argv[1:])


def render_entry():
    main(["render"] + sys.argv[1:])


if __name__ == "__main__":
    main()
