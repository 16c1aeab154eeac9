"""The port's CLI: `python -m embodied_object_detection_tpu_torch.run`.

Counterpart of the JAX package's `run.py` (the reference's train_mp3d.py,
ref: Detic/train_mp3d.py:661-857): without `--eval-only` it trains over
an h5 episode root (`engine/train.py:train` on `data.EpisodeDataset`,
each chunk's precomputed memory from `--semmap-path` snapshots), for
`--max-iter` iterations, from the latest checkpoint with `--resume`;
`--eval-only` runs the serial episode protocol
(`engine/eval.py:evaluate_dataset`) over an h5 episode root and prints
overall and quartile COCO bbox AP with the timing split; `--dry-run`
checks the four golden configurations and the three GT-memory baselines
end to end on synthetic stand-ins and prints the golden commands.
`--eval-streams N` (with `--eval-only`) runs the episode-parallel
protocol (`engine/eval.py:evaluate_dataset_sharded`): the scenes over N
lanes, the lanes over the ranks of the process mesh's data axis.
`--coordinator host:port` starts the process group
(`parallel/mesh.py:init_distributed`: NCCL on the card, gloo on the CPU)
with the rank and world size `torchrun` sets (RANK, WORLD_SIZE,
LOCAL_RANK); training then runs data-parallel over the mesh, and
`--eval-streams` splits its lanes over the ranks.
`--coco-json` is the vanilla single-frame path (the reference's
Detic/train_net.py): the detector with `memory_type` image_only (unless
`--opts` sets one) trains box-supervised over a COCO json's images
(`--image-root`, else `--data-path`) in epoch permutations and then, with
`--coco-json-test`, evaluates; with `--eval-only` it evaluates the json
(`engine/coco.py:evaluate_coco`); `--lvis-eval` remaps the category ids
to a contiguous 0-based space and scores under the LVIS-federated
protocol. `roi.head_type=res5` (the single-frame Res5 variant) runs only
with `--coco-json`, and there only to evaluate: it trains from Python
(`models/res5_detector.py:Res5Detector.frame_train`), and either other
use exits, as the JAX CLI does. `roi.head_type=detr` (Deformable-DETR,
sized by the `detr.*` options) is the same: `--coco-json --eval-only`
only (it trains from Python, `detr_train_step_host_matched`). Everything runs on the card (`--device
cuda`, the default) unless `--device cpu` is given; without a card,
`cuda` raises.

Examples:
  # eval, implicit object memory, on the card:
  python -m embodied_object_detection_tpu_torch.run --eval-only \\
      --parity-config implicit_object_memory \\
      --data-path embodied_data/mp3d_example \\
      --weights models/implicit_object_memory.pth
  # the wiring of every golden run, on synthetic data, on the CPU:
  python -m embodied_object_detection_tpu_torch.run --dry-run --device cpu
  # the same over 2 cards, one process each, 4 lanes:
  torchrun --nproc-per-node 2 -m embodied_object_detection_tpu_torch.run \\
      --coordinator 127.0.0.1:29500 --eval-only --eval-streams 4 \\
      --parity-config implicit_object_memory \\
      --data-path embodied_data/mp3d_example \\
      --weights models/implicit_object_memory.pth
  # train 1000 iterations on an h5 root with memory snapshots:
  python -m embodied_object_detection_tpu_torch.run \\
      --data-path embodied_data/mp3d_example --semmap-path SNAPSHOTS \\
      --output-dir output/train --max-iter 1000
  # single-frame training on a COCO json, then its test json's AP:
  python -m embodied_object_detection_tpu_torch.run --coco-json TRAIN.json \\
      --coco-json-test VAL.json --image-root IMAGES --max-iter 1000
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

GOLDEN_PRESETS = ("pretrained", "vanilla_training", "detic_finetuned",
                  "implicit_object_memory")


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="training: continue from the output directory's "
                        "latest checkpoint")
    p.add_argument("--max-iter", type=int, default=None,
                   help="training iterations (default solver.max_iter)")
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a card) or 'cpu'")
    p.add_argument("--data-path", default="embodied_data/mp3d_example")
    p.add_argument("--semmap-path", default="",
                   help="precomputed memory snapshots (MODEL.SEMMAP_PATH)")
    p.add_argument("--weights", default="",
                   help="a detectron2 .pth / .pkl (converted on the fly), "
                        "or a checkpoint file or directory of the port")
    p.add_argument("--zs-weight", default="",
                   help="CLIP class embedding .npy (default: the config's "
                        "zeroshot_weight_path, then the vendored "
                        "data/metadata/mp3d_clip.npy, datasets/metadata and "
                        "--data-path's parent). 'random' = deterministic "
                        "random classifier for synthetic smoke runs.")
    p.add_argument("--output-dir", default="output/eodt")
    p.add_argument("--test-type", default="default",
                   choices=["default", "episodic", "longterm"])
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--eval-streams", type=int, default=1,
                   help="episode-parallel eval streams (scenes partitioned "
                        "over the mesh data axis; must be a multiple of the "
                        "data axis size)")
    p.add_argument("--save-semmap", action="store_true",
                   help="TEST_SAVE_SEMMAP: write per-sequence memory h5")
    p.add_argument("--coordinator", default="",
                   help="host:port of the process group's rendezvous "
                        "(rank and world size from RANK / WORLD_SIZE, as "
                        "torchrun sets them)")
    p.add_argument("--parity-config", default="",
                   choices=("",) + GOLDEN_PRESETS,
                   help="one of the four golden eval configurations")
    p.add_argument("--dry-run", action="store_true",
                   help="check the golden pipelines end to end on synthetic "
                        "stand-ins (config, model, zs_weight lookup, dataset "
                        "-> episode runner -> AP, and the .pth conversion "
                        "when --weights is given), then print the golden "
                        "commands")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the eval here "
                        "(kernels and the port's eodt.* spans)")
    p.add_argument("--coco-json", default="",
                   help="vanilla single-frame train/eval over a COCO-format "
                        "json (the train_net.py path)")
    p.add_argument("--coco-json-test", default="",
                   help="after --coco-json training, evaluate this json")
    p.add_argument("--image-root", default="",
                   help="image directory of --coco-json (default: "
                        "--data-path)")
    p.add_argument("--lvis-eval", action="store_true",
                   help="remap category ids to a contiguous 0-based space "
                        "and score with the LVIS federated protocol "
                        "(neg_category_ids, 300 detections an image)")
    p.add_argument("--opts", nargs="*", default=[],
                   help="config overrides: section.field=value")
    return p


def _vendored_clip_table() -> str:
    return os.path.join(os.path.dirname(__file__), "data", "metadata",
                        "mp3d_clip.npy")


def find_zs_weight(args, num_classes: int,
                   config_path: str = "") -> np.ndarray:
    """The [D, C+1] zero-shot classifier: `--zs-weight random` (a seeded
    random classifier, asked for explicitly), an explicit `--zs-weight`
    path (which must exist and fit), else the first of the config's path,
    the vendored 20-class table, datasets/metadata and the data path's
    parent that fits `num_classes`. Raises listing every path searched: a
    silent random classifier would report garbage AP."""
    from .demo.predictor import build_zs_weight, load_zs_weight_npy
    if args.zs_weight == "random":
        print("zs_weight: deterministic random (requested via --zs-weight)")
        rng = np.random.RandomState(0)
        return build_zs_weight(
            rng.randn(num_classes, 512).astype(np.float32))
    if args.zs_weight:
        if not os.path.exists(args.zs_weight):
            raise FileNotFoundError(
                f"--zs-weight {args.zs_weight!r} does not exist")
        w = load_zs_weight_npy(args.zs_weight)
        if w.shape[1] != num_classes + 1:
            raise ValueError(
                f"--zs-weight {args.zs_weight!r} has {w.shape[1] - 1} "
                f"classes but the config wants {num_classes}")
        print(f"zs_weight from {args.zs_weight}")
        return w
    candidates = [config_path, _vendored_clip_table(),
                  "datasets/metadata/mp3d_clip.npy",
                  os.path.join(args.data_path, "..", "metadata",
                               "mp3d_clip.npy")]
    skipped = []
    for c in candidates:
        if c and os.path.exists(c):
            w = load_zs_weight_npy(c)
            if w.shape[1] != num_classes + 1:
                skipped.append(f"{c} ({w.shape[1] - 1} classes, "
                               f"config wants {num_classes})")
                continue
            print(f"zs_weight from {c}")
            return w
    lines = "\n  ".join([c for c in candidates if c] +
                        [f"[wrong size] {s}" for s in skipped])
    raise FileNotFoundError(
        "no CLIP class-embedding .npy found for "
        f"{num_classes} classes; searched:\n  {lines}\n"
        "Pass --zs-weight <path>.")


def find_clip_table_path(args, cfg) -> str:
    """The raw [C, D] CLIP class table .npy of the GT-memory baselines
    (the dataset prepends the zero row itself, loader.py:233-246)."""
    candidates = [args.zs_weight if args.zs_weight != "random" else "",
                  cfg.zeroshot_weight_path, _vendored_clip_table(),
                  "datasets/metadata/mp3d_clip.npy",
                  os.path.join(args.data_path, "..", "metadata",
                               "mp3d_clip.npy")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    lines = "\n  ".join(c for c in candidates if c)
    raise FileNotFoundError(
        f"memory_type={cfg.memory.memory_type!r} needs the CLIP class "
        f"table .npy; searched:\n  {lines}")


GOLDEN_COMMANDS = """\
# The four golden parity runs (ref: Detic/README.md:44-62). Each reports
# overall + quartile COCO bbox AP; the 0.1-mAP gate compares them against
# the PyTorch reference's numbers on the same mp3d_example data.
python -m embodied_object_detection_tpu_torch.run --eval-only \\
    --parity-config pretrained --data-path {data} \\
    --weights models/detic_pretrained.pth
python -m embodied_object_detection_tpu_torch.run --eval-only \\
    --parity-config vanilla_training --data-path {data} \\
    --weights models/vanilla_training.pth
python -m embodied_object_detection_tpu_torch.run --eval-only \\
    --parity-config detic_finetuned --data-path {data} \\
    --weights models/detic_finetuned.pth
python -m embodied_object_detection_tpu_torch.run --eval-only \\
    --parity-config implicit_object_memory --data-path {data} \\
    --weights models/implicit_object_memory.pth"""


def _shrink_for_dry_run(cfg):
    """Miniature shapes for a quick wiring check; parameter shapes do not
    depend on the resolution, so the converter check still sees the real
    ones."""
    dc = dataclasses
    return cfg.replace(
        compute_dtype="float32",
        input=dc.replace(cfg.input, height=64, width=96,
                         max_sequence_length=4, score_every=2,
                         max_gt_boxes=8),
        centernet=dc.replace(cfg.centernet, pre_nms_topk_test=32,
                             post_nms_topk_test=8),
        roi=dc.replace(cfg.roi, detections_per_image=8),
        memory=dc.replace(cfg.memory, max_cells=64, write_topk=4,
                          cls_score_thresh=0.05),
    )


def _dry_run_extended_surfaces(args) -> dict:
    """The sharded (`--eval-streams`) protocol over 2 lanes, and the three
    GT-memory baselines (semantic_gt, map_gt, explicit_map) through the
    serial protocol on synthetic stand-ins, with the vendored class table
    for the first two; semantic_gt also through the sharded protocol."""
    from .config import parity_config
    from .data import EpisodeDataset, generate_synthetic_dataset
    from .engine.eval import evaluate_dataset, evaluate_dataset_sharded
    from .models.detector import build_detector

    results = {}
    mini = _shrink_for_dry_run(parity_config("implicit_object_memory"))
    rng = np.random.RandomState(0)
    zs = rng.randn(mini.roi.zs_weight_dim,
                   mini.roi.num_classes + 1).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "synth")
        generate_synthetic_dataset(root, num_scenes=2, chunks_per_scene=2,
                                   frames=4, height=64, width=96,
                                   map_h=8, map_w=8)
        cfg_out = mini.replace(output_dir=os.path.join(td, "out"))
        model = build_detector(cfg_out, seed=0, device=args.device)
        res = evaluate_dataset_sharded(
            model, cfg_out, EpisodeDataset(root, max_sequence_length=4,
                                           max_gt=8),
            zs, streams=2, verbose=False, num_workers=0)
        if res.num_images <= 0:
            raise RuntimeError("sharded dry-run consumed no images")
        results["sharded"] = res.overall
        print(f"[dry-run] sharded eval (2 streams): OK ({res.num_images} "
              "images)")
        for mt in ("semantic_gt", "map_gt", "explicit_map"):
            cfg_mt = cfg_out.replace(
                memory=dataclasses.replace(cfg_out.memory, memory_type=mt))
            clip_path = ""
            if mt in ("semantic_gt", "map_gt"):
                clip_path = find_clip_table_path(args, cfg_mt)
            model = build_detector(cfg_mt, seed=0, device=args.device)
            ds = EpisodeDataset(root, max_sequence_length=4, max_gt=8,
                                memory_type=mt, clip_path=clip_path)
            res = evaluate_dataset(model, cfg_mt, ds, zs, verbose=False,
                                   num_workers=0)
            if res.num_images <= 0:
                raise RuntimeError(f"{mt} dry-run consumed no images")
            results[mt] = res.overall
            how = "serial"
            if mt == "semantic_gt":
                # the lanes' external tables
                evaluate_dataset_sharded(model, cfg_mt, ds, zs, streams=2,
                                         verbose=False, num_workers=0)
                how = "serial + sharded"
            print(f"[dry-run] {mt} baseline eval OK ({how}, "
                  f"{res.num_images} images)")
    return results


def parity_dry_run(args) -> dict:
    """For each golden configuration: build it, find its zs_weight, run
    a synthetic root through the whole protocol (dataset -> episode runner
    -> on-the-fly COCO GT -> AP) at miniature shapes, with a given `.pth`
    checked against the model and loaded; then the GT-memory baselines
    (all presets only). Prints the golden commands."""
    from .config import parity_config
    from .data import EpisodeDataset, generate_synthetic_dataset
    from .engine.eval import evaluate_dataset
    from .models.detector import build_detector

    names = [args.parity_config] if args.parity_config else \
        list(GOLDEN_PRESETS)
    out = {}
    for name in names:
        cfg = parity_config(name)
        zs_full = find_zs_weight(args, cfg.roi.num_classes,
                                 cfg.zeroshot_weight_path)
        if zs_full.shape != (cfg.roi.zs_weight_dim,
                             cfg.roi.num_classes + 1):
            raise RuntimeError(
                f"{name}: zs_weight shape {zs_full.shape} != expected "
                f"({cfg.roi.zs_weight_dim}, {cfg.roi.num_classes + 1})")
        mini = _shrink_for_dry_run(cfg)
        model = build_detector(mini, seed=0, device=args.device)
        if args.weights and args.weights.endswith((".pth", ".pkl")) \
                and os.path.exists(args.weights):
            load_weights(model, mini, args.weights)
        with tempfile.TemporaryDirectory() as td:
            root = os.path.join(td, "synth")
            generate_synthetic_dataset(root, num_scenes=1,
                                       chunks_per_scene=2, frames=4,
                                       height=64, width=96, map_h=8,
                                       map_w=8)
            ds = EpisodeDataset(root, test_type=mini.memory.test_type,
                                max_sequence_length=4, max_gt=8)
            mini = mini.replace(output_dir=os.path.join(td, "out"))
            rng = np.random.RandomState(0)
            zs = rng.randn(mini.roi.zs_weight_dim,
                           mini.roi.num_classes + 1).astype(np.float32)
            res = evaluate_dataset(model, mini, ds, zs, verbose=False,
                                   num_workers=0)
        if res.num_images <= 0:
            raise RuntimeError(f"{name}: eval consumed no images")
        if not all(np.isfinite(v) for v in res.overall.values()):
            raise RuntimeError(f"{name}: non-finite AP in {res.overall}")
        out[name] = res.overall
        print(f"[dry-run] {name}: synthetic eval OK ({res.num_images} "
              f"images, AP={res.overall.get('AP', 0):.3f} on random "
              "weights)")
    if not args.parity_config:
        out["surfaces"] = _dry_run_extended_surfaces(args)
    print("[dry-run] all parity pipelines verified on stand-ins. When the "
          ".pth weights and mp3d_example exist, run:")
    print(GOLDEN_COMMANDS.format(data=args.data_path))
    return out


def load_weights(model, cfg, path: str):
    """Load `path` into `model`: a detectron2 .pth / .pkl, converted and
    required to match the model, or a checkpoint of the port. Returns the
    .pth's zs_weight buffer (the classifier it was trained with), else
    None."""
    if path.endswith((".pth", ".pkl")):
        from .convert.torch_weights import (load_torch_checkpoint,
                                            verify_against_model)
        converted, zs_weight = load_torch_checkpoint(path)
        missing, extra, mismatch = verify_against_model(converted, model)
        print(f"converted {path}: missing={len(missing)} "
              f"extra={len(extra)} mismatch={len(mismatch)}")
        if missing or mismatch:
            detail = "; ".join(
                [f"missing: {missing[:5]}" if missing else "",
                 f"mismatch: {mismatch[:5]}" if mismatch else ""]
            ).strip("; ")
            raise RuntimeError(
                f"checkpoint {path} did not convert cleanly ({detail}); "
                "refusing to run with randomly initialized parameters")
        sd = converted["state_dict"]
        model.load_state_dict({k: sd[k] for k in model.state_dict()})
        return zs_weight
    from .engine.checkpoint import latest_checkpoint, restore_checkpoint
    from .parallel.train_step import make_train_step
    ckpt = latest_checkpoint(path) if os.path.isdir(path) else path
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint in {path}")
    init_state, _ = make_train_step(model, cfg)
    restore_checkpoint(ckpt, init_state())
    return None


def coco_epoch_indices(it: int, n: int, batch: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """The images of iteration `it` over a dataset of `n`: detectron2's
    TrainingSampler, an endless run of permutations without replacement
    (samplers/distributed_sampler.py), each epoch's permutation keyed on
    the epoch so that a resumed run reads the same one; `rng` draws with
    replacement when the dataset is smaller than a batch."""
    if n < batch:
        return rng.choice(n, batch, replace=True)
    per_epoch = max(n // batch, 1)
    epoch, slot = divmod(it, per_epoch)
    perm = np.random.RandomState(np.random.SeedSequence(
        [0x5EED, epoch]).generate_state(1)[0]).permutation(n)
    return perm[slot * batch:(slot + 1) * batch]


def coco_main(args, model, cfg, zs_weight):
    """The `--coco-json` branch: evaluation with `--eval-only`, else
    box-supervised training (then `--coco-json-test`'s evaluation). Ids
    stay raw (the mp3d jsons use vocabulary indices as ids) unless
    `--lvis-eval` remaps them; training raises when a raw id does not fit
    `roi.num_classes`."""
    from .data.catalog import CocoDetectionDataset, DatasetEntry
    from .engine.coco import evaluate_coco, items_to_train_batch

    def coco_ds(json_file):
        return CocoDetectionDataset(
            DatasetEntry(json_file, args.image_root or args.data_path),
            height=cfg.input.height, width=cfg.input.width,
            max_gt=cfg.input.max_gt_boxes, remap_ids=args.lvis_eval)

    def evaluate(json_file):
        res = evaluate_coco(model, cfg, coco_ds(json_file), zs_weight,
                            federated=args.lvis_eval)
        print("coco:", {k: round(v, 3) for k, v in res.items()
                        if not k.startswith("AP-")})
        return res

    if args.eval_only:
        return evaluate(args.coco_json)
    if cfg.roi.head_type == "res5":
        raise SystemExit(
            "CLI training drives the cascade trainer "
            "(parallel/train_step.py); the Res5 variant trains per frame "
            "through Res5Detector.frame_train (its single-frame "
            "normalisation): use it from Python")
    if cfg.roi.head_type == "detr":
        raise SystemExit(
            "CLI training drives the cascade trainer "
            "(parallel/train_step.py); Deformable-DETR trains through "
            "models/deformable_detr.py:detr_train_step_host_matched (its "
            "host-side Hungarian matching): use it from Python")
    from .engine.train import train
    ds = coco_ds(args.coco_json)
    max_cid = max(ds.entry.id_map.values(), default=0)
    if max_cid >= cfg.roi.num_classes:
        # raw ids beyond the classifier's columns would train nothing
        # while the loss stays finite
        raise SystemExit(
            f"--coco-json training: max category id {max_cid} in "
            f"{args.coco_json} does not fit roi.num_classes="
            f"{cfg.roi.num_classes}. For 1-based / non-contiguous jsons "
            "(COCO, LVIS) pass --lvis-eval to remap ids to a contiguous "
            "0-based space, or set --opts roi.num_classes="
            f"{max_cid + 1} to keep raw ids (mp3d-style jsons)")
    bsz = cfg.solver.ims_per_batch

    def coco_batch(it, rng, dp):
        idx = coco_epoch_indices(it, len(ds), bsz, rng)
        return items_to_train_batch([ds[int(i)] for i in idx], cfg,
                                    pad_to_multiple=dp)

    state = train(model, cfg, None, zs_weight, max_iter=args.max_iter,
                  resume=args.resume, batch_fn=coco_batch)
    if args.coco_json_test:
        return state, evaluate(args.coco_json_test)
    print("no --coco-json-test given; skipping the post-training eval")
    return state


def main(argv=None):
    """CLI entry point. Returns {preset: overall AP} for --dry-run, the
    `EvalResults` for --eval-only and the final `TrainState` for
    training; with --coco-json the AP dict for --eval-only, else the
    final `TrainState`, with the test json's AP dict beside it when
    --coco-json-test is given."""
    from .models.detector import resolve_device
    args = argument_parser().parse_args(argv)
    resolve_device(args.device)
    if args.dry_run:
        return parity_dry_run(args)
    if args.coordinator:
        from .parallel.mesh import init_distributed
        init_distributed(args.coordinator, args.device)

    from .config import DetectorConfig, apply_opts, parity_config
    from .data import EpisodeDataset
    from .engine.eval import evaluate_dataset, evaluate_dataset_sharded
    from .models.detector import build_detector

    cfg = parity_config(args.parity_config) if args.parity_config \
        else DetectorConfig()
    cfg = cfg.replace(
        output_dir=args.output_dir, test_data_path=args.data_path,
        train_data_path=args.data_path, semmap_path=args.semmap_path,
        memory=dataclasses.replace(cfg.memory, test_type=args.test_type,
                                   save_semmap=args.save_semmap))
    cfg = apply_opts(cfg, args.opts)
    if args.coco_json and not args.parity_config and not any(
            str(o).startswith("memory.memory_type") for o in args.opts):
        # the reference's single-frame path leaves MODEL.MEMORY_TYPE at ''
        # (no FPN memory merge, timm.py:142); an explicit --opts or a
        # golden preset wins
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, memory_type="image_only"))
        print("--coco-json: memory_type defaulted to image_only "
              "(single-frame contract; override via --opts)")
    elif args.coco_json and cfg.memory.reads_memory():
        print(f"warning: --coco-json with memory_type="
              f"{cfg.memory.memory_type!r} runs the FPN memory merge "
              "against all-zero memory every frame")
    if args.coco_json:
        # no memory is carried from image to image: the write is dead work
        cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                     write_memory=False))
    if cfg.output_dir.endswith("/auto"):
        # ref: train_mp3d.py:678-689, a config-derived dated run directory
        import datetime
        tag = args.parity_config or cfg.memory.memory_type or "default"
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        cfg = cfg.replace(output_dir=os.path.join(
            os.path.dirname(cfg.output_dir), f"{tag}-{stamp}"))
        print(f"output dir (auto): {cfg.output_dir}")
    os.makedirs(cfg.output_dir, exist_ok=True)

    if cfg.roi.head_type in ("res5", "detr") and not args.coco_json:
        raise SystemExit(
            f"roi.head_type={cfg.roi.head_type} is a single-frame variant "
            "(no memory inputs): use it with --coco-json single-frame "
            "evaluation, not the episode protocol")
    model = build_detector(cfg, seed=0, device=args.device)
    if args.weights:
        load_weights(model, cfg, args.weights)
    zs_weight = find_zs_weight(args, cfg.roi.num_classes,
                               cfg.zeroshot_weight_path)

    if args.coco_json:
        return coco_main(args, model, cfg, zs_weight)
    clip_path = ""
    if cfg.memory.memory_type in ("semantic_gt", "map_gt"):
        # these baselines read the CLIP class table through the dataset
        # (loader.py:139-142, 233-246); explicit_map reads the memory h5's
        # or the snapshot's values, in training as in evaluation
        clip_path = find_clip_table_path(args, cfg)
        print(f"GT-memory table from {clip_path}")
    if not args.eval_only:
        from .engine.train import train
        dataset = EpisodeDataset(
            cfg.train_data_path,
            max_sequence_length=cfg.input.max_sequence_length,
            max_gt=cfg.input.max_gt_boxes,
            memory_type=cfg.memory.memory_type, clip_path=clip_path,
            semmap_path=cfg.semmap_path,
            semmap_dialect=cfg.memory.semmap_dialect)
        return train(model, cfg, dataset, zs_weight, max_iter=args.max_iter,
                     resume=args.resume)
    dataset = EpisodeDataset(
        cfg.test_data_path, test_type=cfg.memory.test_type,
        max_sequence_length=cfg.input.max_sequence_length,
        max_gt=cfg.input.max_gt_boxes, memory_type=cfg.memory.memory_type,
        clip_path=clip_path, semmap_path=cfg.semmap_path,
        semmap_dialect=cfg.memory.semmap_dialect)
    if args.eval_streams > 1:
        if args.max_chunks:
            print("warning: --max-chunks is ignored with --eval-streams "
                  "(scene partitioning needs the full chunk list)")
        results = evaluate_dataset_sharded(
            model, cfg, dataset, zs_weight, streams=args.eval_streams,
            profile_dir=args.profile_dir or None)
    else:
        results = evaluate_dataset(model, cfg, dataset, zs_weight,
                                   max_chunks=args.max_chunks,
                                   profile_dir=args.profile_dir or None)
    print("overall:", {k: round(v, 3) for k, v in results.overall.items()})
    for i, q in enumerate(results.quartiles):
        if q:
            print(f"quartile {i + 1}: AP={q.get('AP', float('nan')):.3f}")
    return results


if __name__ == "__main__":
    main()
