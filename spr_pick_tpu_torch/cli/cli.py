"""The command line of the PyTorch port.

    python -m spr_pick_tpu_torch train start -a ssdn -n gauss \
        --noise_value const -t imgs.txt -l coords.txt --alpha 0.8 \
        --tau 0.01 --iterations 200000
    python -m spr_pick_tpu_torch train start --dn_only -a n2v -n gauss25 \
        -t mics/ -l none --alpha 0.8 --tau 0.01 --iterations 200000 \
        -v val/ -vgt val_gt/
    python -m spr_pick_tpu_torch train resume hi_runs/00000-train-...
    python -m spr_pick_tpu_torch pick -m model.wt mics/ -o picks.star
    python -m spr_pick_tpu_torch eval -m model.wt -d imgs.txt -l coords.txt

The port of `spr_pick_tpu/cli/cli.py`: the same subcommands, flags,
defaults and outputs, plus ``--device`` (the GPU unless given).  No
command needs pandas or PIL: tables are read and written with the `csv`
module and PNGs with `zlib`.  `train start --dn_only` trains the
denoise-only algorithms on a folder of micrographs or an HDF5 file (or
ssdn on a TXT manifest); ``-l/--alpha/--tau`` stay required there, as in
the JAX command.  HDF5 datasets need h5py, imported when one is opened.

``train --mesh D`` trains data-parallel on D ranks, one process a GPU
(NCCL), started here; the default is every visible GPU, and with
``--device cpu`` D gloo ranks on the CPU.  Under ``torchrun
--nproc_per_node D -m spr_pick_tpu_torch train ...`` (and ``eval``) each
process joins torchrun's group instead.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue


def _add_star_args(parser: argparse.ArgumentParser, what: str) -> None:
    parser.add_argument("--star_threshold", type=float, default=0.13,
                        help=f"Score threshold for {what}")
    parser.add_argument("--star_scale", type=float, default=4.0,
                        help=f"Coordinate upscale for {what} (binning undo)")
    parser.add_argument("--star_borders", type=int, nargs=4, default=None,
                        metavar=("XMIN", "XMAX", "YMIN", "YMAX"),
                        help=f"Keep-window for {what}, applied after scaling")


def _add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU; 'cpu' to run "
                        "on the CPU)")


def _add_shared_args(parser: argparse.ArgumentParser, start: bool):
    parser.add_argument("--train_dataset", "-t", required=start,
                        help="Path to training dataset (TXT manifest, or a "
                        "folder of images or an .h5 file with --dn_only).")
    parser.add_argument("--alpha", "-ap", type=float, required=start,
                        help="alpha value (denoise-vs-detect blend)")
    parser.add_argument("--tau", "-tau", type=float, required=start,
                        help="tau for PU learning - expected fraction of "
                        "positives")
    parser.add_argument("--train_gt", "-gt",
                        help="Path to ground truth dataset")
    parser.add_argument("--train_label", "-l", required=start,
                        help="Path to training coordinate labels")
    parser.add_argument("--validation_dataset", "-v",
                        help="Validation dataset path")
    parser.add_argument("--validation_label", "-vl",
                        help="Validation labels path")
    parser.add_argument("--validation_gt", "-vgt",
                        help="Validation ground truth path")
    parser.add_argument("--iterations", "-iter", required=start, type=int,
                        help="Number of training iterations")
    parser.add_argument("--num", "-num", type=int, default=1,
                        help="Number of eval samples during training")
    parser.add_argument("--lr", "-lr", type=float, help="learning rate")
    parser.add_argument("--nms", "-nms", type=int,
                        help="non-maximum suppression radius")
    parser.add_argument("--max_peaks", type=int,
                        help="per-map cap of the NMS pick list (default "
                        "2048); a full list retries with a doubled cap")
    parser.add_argument("--bb", "-bb", type=int,
                        help="bounding box radius of particles")
    parser.add_argument("--eval_interval", type=int)
    parser.add_argument("--checkpoint_interval", type=int)
    parser.add_argument("--print_interval", type=int)
    parser.add_argument("--train_batch_size", type=int)
    parser.add_argument("--validation_batch_size", type=int)
    parser.add_argument("--patch_size", type=int)
    parser.add_argument("--seed", type=int, help="Base PRNG seed")
    parser.add_argument("--mesh", type=int,
                        help="Data-parallel mesh size: the number of ranks, "
                        "one a GPU (default: every visible GPU; with "
                        "--device cpu, gloo ranks on the CPU, default 1)")
    _add_device_arg(parser)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="spr_pick_tpu_torch",
        description="Joint cryo-EM denoising + picking on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    # --- train ---
    train = sub.add_parser("train", help="Train or resume a model")
    train_sub = train.add_subparsers(dest="train_cmd", required=True)
    start = train_sub.add_parser("start", help="Start a new training run")
    _add_shared_args(start, True)
    start.add_argument("--algorithm", "-a", required=True,
                       choices=[a.value for a in NoiseAlgorithm],
                       help="The algorithm to train.")
    start.add_argument("--noise_style", "-n", required=True,
                       help="Noise style: gauss{SD}[_{MAX}][_nc] or "
                       "poisson{LAM}[_{MAX}][_nc]")
    start.add_argument("--noise_value", choices=[v.value for v in NoiseValue],
                       help="Whether the noise sigma is known / const / "
                       "var-estimated")
    start.add_argument("--dn_only", action="store_true",
                       help="denoising only")
    start.add_argument("--noise_input", action="store_true",
                       help="Also add the synthetic noise to the network "
                       "INPUT (denoise-only training, for clean benchmark "
                       "datasets; the reference ships this switch disabled, "
                       "noise_wrapper.py:123)")
    start.add_argument("--runs_dir", default=cfg_mod.DEFAULT_RUN_DIR)
    start.add_argument("--profile", action="store_true",
                       help="Capture a torch.profiler trace of the first "
                       "print window")
    resume = train_sub.add_parser("resume", help="Resume a training run")
    resume.add_argument("run_dir", help="Run directory to resume")
    resume.add_argument("--iteration", type=int, default=None,
                        help="Resume from a specific "
                        "model_{iter:08d}.training snapshot instead of the "
                        "latest (rollback)")
    _add_shared_args(resume, False)

    # --- eval ---
    ev = sub.add_parser("eval", help="Evaluate a trained model")
    ev.add_argument("--model", "-m", required=True,
                    help=".training or .wt checkpoint")
    ev.add_argument("--dataset", "-d", required=True, help="Eval dataset path")
    ev.add_argument("--gt_dataset", "-gt", "-g",
                    help="Clean ground-truth dataset path")
    ev.add_argument("--labels", "-l", help="Eval coordinate labels (optional)")
    ev.add_argument("--runs_dir", default=cfg_mod.DEFAULT_RUN_DIR)
    ev.add_argument("--batch_size", type=int)
    ev.add_argument("--nms", "-nms", type=int)
    ev.add_argument("--max_peaks", type=int,
                    help="per-map cap of the NMS pick list (default 2048); a "
                    "full list retries with a doubled cap")
    ev.add_argument("--num", "-num", type=int)
    ev.add_argument(
        "--exclude_contam", action="store_true",
        help="Seed NMS with a contamination mask detected on the denoised "
        "output (reference find_contamination hook)",
    )
    ev.add_argument(
        "--export_star", metavar="PATH", nargs="?", const="particles.star",
        help="After eval, aggregate the *_scores.txt picks into a RELION "
        ".star (default particles.star inside the eval run dir)",
    )
    _add_star_args(ev, "--export_star")
    _add_device_arg(ev)

    # --- pick (the Picker as a command; no run dirs) ---
    pick = sub.add_parser(
        "pick",
        help="Pick (and/or denoise) micrographs straight to a picks table",
    )
    pick.add_argument("--model", "-m", required=True,
                      help=".training or .wt checkpoint")
    pick.add_argument(
        "images", nargs="+",
        help="Micrograph paths, directories (searched recursively for "
        "images), and/or TSV manifests (image_name<TAB>path)",
    )
    pick.add_argument(
        "--output", "-o", default="picks.txt",
        help="Picks output: *_scores.txt-schema TSV, a RELION .star (by "
        "extension), or '-' for TSV on stdout (default picks.txt)",
    )
    pick.add_argument("--nms", type=int,
                      help="NMS radius (default: checkpoint cfg)")
    pick.add_argument("--threshold", type=float, default=0.02,
                      help="Heatmap score floor (default 0.02)")
    pick.add_argument("--border", type=int, default=30,
                      help="Edge exclusion in px (default 30; 0 keeps edge "
                      "picks)")
    pick.add_argument("--max_peaks", type=int,
                      help="Pick cap per micrograph (default: checkpoint cfg)")
    pick.add_argument("--batch_size", type=int, default=4,
                      help="Same-shape micrographs per dense forward "
                      "(default 4)")
    pick.add_argument("--standardize", action="store_true",
                      help="Header-based MRC normalisation at load")
    pick.add_argument("--seed", type=int, default=0)
    pick.add_argument(
        "--denoise_dir", metavar="DIR",
        help="Also write the denoised micrographs into DIR (picks and "
        "denoised come from the same forward)",
    )
    pick.add_argument("--denoise_format", choices=["mrc", "png"],
                      default="mrc",
                      help="Denoised output format (mrc: float32 data; png: "
                      "min-max 8-bit view)")
    _add_star_args(pick, ".star outputs")
    _add_device_arg(pick)
    return parser


def _apply_shared(cfg: Dict, trainer, args: Dict):
    for arg, setter in (("train_dataset", trainer.set_train_data),
                        ("train_gt", trainer.set_train_gt_data),
                        ("train_label", trainer.set_train_label),
                        ("validation_dataset", trainer.set_test_data),
                        ("validation_gt", trainer.set_test_gt_data),
                        ("validation_label", trainer.set_test_label)):
        if args.get(arg) is not None:
            setter(args[arg])
    mapping = {
        "iterations": ConfigValue.ITERATIONS,
        "num": ConfigValue.NUM_EVAL,
        "eval_interval": ConfigValue.EVAL_INTERVAL,
        "checkpoint_interval": ConfigValue.SNAPSHOT_INTERVAL,
        "print_interval": ConfigValue.PRINT_INTERVAL,
        "train_batch_size": ConfigValue.TRAIN_MINIBATCH_SIZE,
        "validation_batch_size": ConfigValue.TEST_MINIBATCH_SIZE,
        "patch_size": ConfigValue.TRAIN_PATCH_SIZE,
        "alpha": ConfigValue.ALPHA,
        "tau": ConfigValue.TAU,
        "seed": ConfigValue.SEED,
        "mesh": ConfigValue.MESH_SHAPE,
    }
    for arg, key in mapping.items():
        if args.get(arg) is not None:
            cfg[key] = args[arg]
    # The loss weights live in cfg; keep a resumed trainer's copies in
    # sync when --alpha/--tau are passed again.
    trainer.alpha = float(cfg[ConfigValue.ALPHA])
    trainer.tau = float(cfg[ConfigValue.TAU])


def _mesh_size(args: Dict) -> int:
    """The ranks ``train`` runs on: ``--mesh``, else a resumed run's
    MESH_SHAPE, resolved as the JAX trainer does (`parallel/mesh.py`)."""
    from spr_pick_tpu_torch.parallel import mesh

    requested = args.get("mesh")
    batch = args.get("train_batch_size")
    if args["train_cmd"] == "resume" and (requested is None or batch is None):
        from spr_pick_tpu_torch.train import resume_path
        from spr_pick_tpu_torch.utils import checkpoint as ckpt

        path, _ = resume_path(args["run_dir"], args.get("iteration"))
        cfg = ckpt.load(path)["cfg"]
        requested = cfg.get(ConfigValue.MESH_SHAPE) if requested is None \
            else requested
        batch = cfg[ConfigValue.TRAIN_MINIBATCH_SIZE] if batch is None \
            else batch
    if batch is None:
        batch = cfg_mod.base()[ConfigValue.TRAIN_MINIBATCH_SIZE]
    try:
        return mesh.resolve_size(requested, args.get("device"), batch)
    except mesh.MeshError as exc:
        raise SystemExit(str(exc))


def run_train(args: Dict):
    """``train start|resume`` on one device, on ``--mesh D`` ranks started
    here (one process a rank), or as a rank of ``torchrun``'s group."""
    from spr_pick_tpu_torch.parallel import mesh

    if mesh.torchrun_size() > 1:
        m = mesh.join_torchrun(args.get("device"))
        try:
            if args.get("mesh") not in (None, m.size):
                raise SystemExit(f"--mesh {args['mesh']} under torchrun with "
                                 f"{m.size} ranks")
            _train(args, m)
        finally:
            mesh.teardown(m)
        return
    size = _mesh_size(args)
    if size <= 1:
        _train(args, None)
    else:
        mesh.launch(_train_rank, size, args.get("device"), args)


def _train_rank(m, args: Dict):
    if not m.is_main:
        logging.getLogger().setLevel(logging.WARNING)
    _train(args, m)


def _train(args: Dict, mesh):
    from spr_pick_tpu_torch.train import DenoiserTrainer, resume_run

    if args["train_cmd"] == "start":
        if args["algorithm"] == "ssdn" and args.get("noise_value") is None:
            print("error: SSDN requires --noise_value", file=sys.stderr)
            sys.exit(2)
        cfg = cfg_mod.base()
        cfg[ConfigValue.ALGORITHM] = NoiseAlgorithm(args["algorithm"])
        cfg[ConfigValue.NOISE_STYLE] = args["noise_style"]
        if args.get("noise_value") is not None:
            cfg[ConfigValue.NOISE_VALUE] = NoiseValue(args["noise_value"])
        for arg, key in (("lr", ConfigValue.LEARNING_RATE),
                         ("bb", ConfigValue.BB), ("nms", ConfigValue.NMS),
                         ("max_peaks", ConfigValue.MAX_PEAKS)):
            if args.get(arg) is not None:
                cfg[key] = args[arg]
        if args.get("noise_input"):
            if not args["dn_only"]:
                # Only the denoise data plane reads NOISE_INPUT.
                raise SystemExit(
                    "--noise_input only applies to denoise-only training "
                    "(--dn_only): the joint micrograph path adds no "
                    "synthetic noise")
            cfg[ConfigValue.NOISE_INPUT] = True
        trainer = DenoiserTrainer(
            cfg, mode="denoise" if args["dn_only"] else "joint",
            alpha=args["alpha"], tau=args["tau"],
            runs_dir=args["runs_dir"], profile=bool(args.get("profile")),
            device=args.get("device"), mesh=mesh,
        )
    else:
        trainer = resume_run(args["run_dir"], iteration=args.get("iteration"),
                             device=args.get("device"), mesh=mesh)
        cfg = trainer.cfg
    _apply_shared(cfg, trainer, args)
    trainer.train()


def run_eval(args: Dict):
    """``eval``; as a rank of ``torchrun``'s group, on its shard of the
    micrographs."""
    from spr_pick_tpu_torch.parallel import mesh

    if mesh.torchrun_size() <= 1:
        return _eval(args, None)
    m = mesh.join_torchrun(args.get("device"))
    try:
        _eval(args, m)
    finally:
        mesh.teardown(m)


def _eval(args: Dict, mesh):
    from spr_pick_tpu_torch.eval import DenoiserEvaluator

    evaluator = DenoiserEvaluator(args["model"], runs_dir=args["runs_dir"],
                                  device=args.get("device"), mesh=mesh)
    evaluator.set_test_data(args["dataset"])
    if args.get("labels") is not None:
        evaluator.set_test_label(args["labels"])
    if args.get("gt_dataset") is not None:
        evaluator.set_test_gt_data(args["gt_dataset"])
    for arg, key in (("batch_size", ConfigValue.TEST_MINIBATCH_SIZE),
                     ("nms", ConfigValue.NMS),
                     ("max_peaks", ConfigValue.MAX_PEAKS),
                     ("num", ConfigValue.NUM_EVAL)):
        if args.get(arg) is not None:
            evaluator.cfg[key] = args[arg]
    if args.get("exclude_contam"):
        evaluator.cfg[ConfigValue.EXCLUDE_CONTAM] = True
    evaluator.evaluate()

    if args.get("export_star") and evaluator.is_main:
        from spr_pick_tpu_torch.data.star_export import convert

        out = args["export_star"]
        if not os.path.isabs(out):
            out = os.path.join(evaluator.run_dir_path, out)
        try:
            n = convert(
                os.path.join(evaluator.run_dir_path, "eval_imgs"), out,
                threshold=args["star_threshold"], scale=args["star_scale"],
                borders=args.get("star_borders"),
            )
        except FileNotFoundError as exc:
            raise SystemExit(f"--export_star: {exc}")
        logging.getLogger("cli").info("wrote %d particles to %s", n, out)


def _expand_pick_inputs(items: List[str]):
    """Expand the `pick` positional inputs.

    Each item is a micrograph path, a directory (searched recursively for
    image files), or a TSV manifest with a `path` column (names taken from
    `image_name` when present).  Returns aligned (paths, names); names that
    collide get the suffixes -2, -3, ...
    """
    from spr_pick_tpu_torch.api import Picker
    from spr_pick_tpu_torch.data.folder import find_images
    from spr_pick_tpu_torch.data.table import read_tsv

    paths: List[str] = []
    names: List[Optional[str]] = []
    for item in items:
        if os.path.isdir(item):
            found = sorted(find_images(item))
            if not found:
                raise SystemExit(f"pick: no images found under {item}")
            paths.extend(found)
            names.extend([None] * len(found))
        elif item.lower().endswith((".txt", ".tsv", ".tab")):
            table = read_tsv(item)
            if "path" not in table:
                raise SystemExit(
                    f"pick: manifest {item} has no 'path' column "
                    "(expected image_name<TAB>path)"
                )
            # Paths are used verbatim (absolute or cwd-relative).
            paths.extend(str(p) for p in table["path"])
            if "image_name" in table:
                names.extend(str(n) for n in table["image_name"])
            else:
                names.extend([None] * len(table["path"]))
        else:
            paths.append(item)
            names.append(None)
    names = [Picker._name_for(p) if nm is None else nm
             for nm, p in zip(names, paths)]
    # Basename-derived names can collide across inputs (dirA/mic1.mrc and
    # dirB/mic1.mrc): suffix them so --denoise_dir outputs and picks rows
    # stay distinct.
    counts: Dict[str, int] = {}
    unique = []
    n_dups = 0
    for nm in names:
        if nm in counts:
            n_dups += 1
            counts[nm] += 1
            cand = f"{nm}-{counts[nm]}"
            while cand in counts:
                counts[nm] += 1
                cand = f"{nm}-{counts[nm]}"
            counts[cand] = 1
            unique.append(cand)
        else:
            counts[nm] = 1
            unique.append(nm)
    if n_dups:
        logging.getLogger("cli").warning(
            "pick: %d duplicate image name(s) across inputs; suffixed -2, "
            "-3, ... to keep outputs distinct", n_dups
        )
    return paths, unique


def run_pick(args: Dict):
    from spr_pick_tpu_torch.api import Picker
    from spr_pick_tpu_torch.data import table as tbl
    from spr_pick_tpu_torch.utils import logging_helper

    logging_helper.setup()
    log = logging.getLogger("cli")
    paths, names = _expand_pick_inputs(args["images"])
    picker = Picker(
        args["model"],
        nms_radius=args.get("nms"),
        threshold=args["threshold"],
        max_peaks=args.get("max_peaks"),
        border=args["border"],
        seed=args["seed"],
        device=args.get("device"),
    )

    if args.get("denoise_dir"):
        # One forward per micrograph yields both the picks and the denoised
        # image (Picker.process_table).
        ddir = args["denoise_dir"]
        os.makedirs(ddir, exist_ok=True)
        tables = []
        for path, name in zip(paths, names):
            picks, den = picker.process_table(
                path, name=name, standardize=args["standardize"]
            )
            tables.append(picks)
            out_path = os.path.join(ddir, f"{name}.{args['denoise_format']}")
            if args["denoise_format"] == "mrc":
                from spr_pick_tpu_torch.data import mrc

                mrc.write(out_path, den)
            else:
                from spr_pick_tpu_torch.utils.image_io import save_array_image

                save_array_image(den, out_path)
        log.info("wrote %d denoised micrographs to %s", len(paths), ddir)
        table = tbl.concat(tables)
    else:
        try:
            table = picker.pick_many_table(
                paths, names=names, standardize=args["standardize"],
                batch_size=args["batch_size"],
            )
        except ValueError as exc:
            raise SystemExit(f"pick: {exc}")

    out = args["output"]
    if out == "-":
        tbl.write_tsv(sys.stdout, table)
    elif out.lower().endswith(".star"):
        from spr_pick_tpu_torch.data.star_export import frame_to_star

        n = frame_to_star(
            table, out, threshold=args["star_threshold"],
            scale=args["star_scale"], borders=args.get("star_borders"),
        )
        log.info("wrote %d particles (of %d picks) to %s", n,
                 tbl.num_rows(table), out)
    else:
        with open(out, "w", newline="") as f:
            tbl.write_tsv(f, table)
        log.info("wrote %d picks to %s", tbl.num_rows(table), out)


def start(argv: Optional[List[str]] = None):
    args = vars(build_parser().parse_args(argv))
    if args["command"] == "train":
        run_train(args)
    elif args["command"] == "eval":
        run_eval(args)
    else:
        run_pick(args)


if __name__ == "__main__":
    start()
