"""Weight conversion CLI of the PyTorch port, flag-compatible with the JAX
package's ``apps/convert.py``.

It converts the artifacts the reference deploys into the port's checkpoint
directory (``weights/checkpoint.py``), which ``apps/e2e.py`` and
``TwoStagePipeline.from_jax_vars`` load:

* torch ``.pth`` state dicts (classifiers and detectors),
* Ultralytics ``.pt`` training containers (``best.pt``/``last.pt``),
  unpickled without ultralytics,
* ``.onnx`` exports (fused or unfused initializers, read without the onnx
  package),
* NCNN ``.param`` graphs (+ ``--bin``), the variant checked against the
  graph topology,
* OpenVINO IR ``.xml`` (+ sibling or ``--bin`` weights),
* port checkpoint directories.  An orbax directory (the JAX package's
  format) exits with rc 2: reading it needs JAX.

``--emit ncnn|onnx|openvino`` goes the other way: it writes a deployable
graph (the port's emitters, ``weights/{ncnn,onnx,openvino}_export.py``,
byte-equal to the JAX emitters'), so a detector converted or trained by the
port drops back onto the reference's Pi pipeline.  ``--emit checkpoint``
(the default) writes the port's checkpoint; ``orbax``, the JAX CLI's name
for its default, is accepted as an alias and writes the same.

    python -m litepi_tpu_torch.apps.convert \
        --arch shufflenetv2 --num_classes 91 \
        --input weights/shufflenetv2.pth --output ckpt/shufflenetv2

    python -m litepi_tpu_torch.apps.convert \
        --arch yolo_plus_v2 --num_classes 1 \
        --input runs/train/best.pt --output out/ncnn --emit ncnn

A smoke test runs after conversion: a seeded input through the port's
model on ``--device`` (the card by default; it raises without one; float32
with TF32 off) must give finite outputs of the right shape.  The flags are
the JAX CLI's plus ``--device``, so one command line runs on both.
"""

from __future__ import annotations

import argparse
import sys

CLASSIFIER_ARCHS = ("shufflenetv2", "resnet18", "mobilenetv2", "efficientnet")
DETECTOR_ARCHS = ("yolo_plus_v2", "yolo_plus_v1", "yolov8n")
# baseline variants with their own Flax models (no yolo_plus DetectorConfig);
# the deployed 'yolo5' is the u-variant — see models/yolov5.py
VARIANT_ARCHS = {"yolov5n": "yolov5nu", "yolov11n": "yolov11n"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert torch/.pt/.onnx/NCNN/OpenVINO weights -> a port "
        "checkpoint or a deployable graph"
    )
    p.add_argument(
        "--arch", required=True,
        choices=list(CLASSIFIER_ARCHS) + list(DETECTOR_ARCHS)
        + list(VARIANT_ARCHS),
    )
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument(
        "--input", required=True,
        help=".pth state dict, ultralytics .pt container, .onnx export, "
        "NCNN .param graph, or OpenVINO .xml IR",
    )
    p.add_argument(
        "--bin", default=None,
        help="weights blob for .param/.xml inputs (default: the sibling "
        ".bin next to the graph file)",
    )
    p.add_argument(
        "--output", required=True,
        help="checkpoint dir (or the emitted graph's dir / .onnx / .xml path)",
    )
    p.add_argument("--input_size", type=int, default=64)
    p.add_argument(
        "--emit", choices=("checkpoint", "orbax", "ncnn", "onnx", "openvino"),
        default="checkpoint",
        help="output format: the port's checkpoint dir (default; 'orbax', "
        "the JAX CLI's name for its default, is an alias); an NCNN "
        ".param/.bin pair — the reference deployment's native format "
        "(e2e.py:195-220); a .onnx file — the reference's interchange "
        "format its other artifacts convert from; or an OpenVINO IR "
        ".xml/.bin pair (runner.py:175-222 compiles these).  Any emission "
        "drops a detector trained/converted here straight back onto the "
        "Pi pipeline",
    )
    p.add_argument(
        "--emit_dtype", choices=("fp32", "fp16"), default="fp32",
        help="NCNN weight storage (the reference's shipped bins are fp16)",
    )
    p.add_argument(
        "--emit_input_size", type=int, default=640,
        help="deployment resolution baked into an emitted detector graph "
        "(anchor tables, per-level reshapes — the reference deploys at "
        "640); independent of --input_size, which sizes the smoke test",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the smoke test runs the port's model (default the card)",
    )
    args = p.parse_args(argv)

    if args.emit == "ncnn" and args.arch in CLASSIFIER_ARCHS and (
        args.arch != "shufflenetv2"
    ):
        print(
            "error: --emit ncnn covers the detector families "
            "(yolo_plus/yolov8n/yolov5n/yolov11n) and shufflenetv2 (the "
            "deployed classifier); other classifier graph emission is not "
            "implemented — use --emit orbax",
            file=sys.stderr,
        )
        return 2
    if args.emit == "onnx" and args.arch not in DETECTOR_ARCHS and (
        args.arch != "shufflenetv2"
    ):
        print(
            "error: --emit onnx covers the yolo_plus/yolov8n family "
            "(the shipped yolo_plus.onnx's graph vocabulary) and "
            "shufflenetv2 (the deployed classifier); use --emit ncnn, "
            "openvino or orbax for other archs",
            file=sys.stderr,
        )
        return 2
    if args.emit == "openvino" and args.arch not in DETECTOR_ARCHS and (
        args.arch not in VARIANT_ARCHS
    ) and args.arch != "shufflenetv2":
        print(
            "error: --emit openvino covers the detector families "
            "(yolo_plus/yolov8n/yolov5n/yolov11n — the shipped IR "
            "vocabularies) and shufflenetv2 (the deployed classifier); "
            "use --emit orbax for other archs",
            file=sys.stderr,
        )
        return 2

    import numpy as np

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.weights.checkpoint import save_checkpoint

    dev = resolve_device(args.device)  # raises without a card, as apps/e2e.py

    variant = VARIANT_ARCHS.get(args.arch)
    is_detector = args.arch in DETECTOR_ARCHS or variant is not None
    cfg = None
    if is_detector and variant is None:
        import dataclasses

        from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N

        cfg = {
            "yolo_plus_v2": YOLO_PLUS_V2,
            "yolo_plus_v1": YOLO_PLUS_V1,
            "yolov8n": YOLOV8N,
        }[args.arch]
        # fold the requested head width in BEFORE conversion so topology
        # verification and the converted cls-head shapes agree with the
        # smoke-test model below (the presets are all single-class)
        cfg = dataclasses.replace(cfg, num_classes=args.num_classes)

    def _variant_convert_sd(sd):
        from litepi_tpu_torch.weights.ncnn_import import variant_state_converter
        from litepi_tpu_torch.weights.onnx_import import defuse_state_dict

        return variant_state_converter(variant)(defuse_state_dict(sd))

    # ---- read + convert ------------------------------------------------ #
    import os as _os

    try:
        if _os.path.isdir(args.input):
            # a port checkpoint (an earlier convert output), the natural
            # source of --emit re-exports; an orbax directory raises here
            from litepi_tpu_torch.weights.checkpoint import load_checkpoint

            variables = load_checkpoint(args.input)
        elif args.input.endswith((".param", ".xml")):
            if not is_detector and args.arch != "shufflenetv2":
                print(
                    "error: classifier graph ingestion covers shufflenetv2 "
                    "pairs (the canonical emission); other classifier "
                    "graphs lose their torch names in exports — convert "
                    "from the .pth or a name-preserving .onnx instead",
                    file=sys.stderr,
                )
                return 2
            import os

            bin_path = args.bin or os.path.splitext(args.input)[0] + ".bin"
            if not is_detector:
                if args.input.endswith(".param"):
                    from litepi_tpu_torch.weights.ncnn_import import (
                        convert_classifier_ncnn,
                    )

                    variables, ncls = convert_classifier_ncnn(
                        args.input, bin_path
                    )
                else:
                    from litepi_tpu_torch.weights.openvino_import import (
                        convert_classifier_openvino_fused,
                    )

                    variables, ncls = convert_classifier_openvino_fused(
                        args.input, bin_path
                    )
                if ncls != args.num_classes:
                    raise ValueError(
                        f"graph has {ncls} classes, --num_classes says "
                        f"{args.num_classes}"
                    )
            elif args.input.endswith(".param"):
                if variant is not None:
                    from litepi_tpu_torch.weights.ncnn_import import (
                        convert_detector_ncnn_variant,
                    )

                    variables = convert_detector_ncnn_variant(
                        args.input, bin_path, variant, args.num_classes
                    )
                else:
                    from litepi_tpu_torch.weights.ncnn_import import (
                        convert_detector_ncnn,
                    )

                    variables, _ = convert_detector_ncnn(
                        args.input, bin_path, cfg
                    )
            else:
                if variant is not None:
                    from litepi_tpu_torch.weights.openvino_import import (
                        convert_detector_openvino_variant,
                    )

                    variables = convert_detector_openvino_variant(
                        args.input, bin_path, variant, args.num_classes
                    )
                else:
                    from litepi_tpu_torch.weights.openvino_import import (
                        convert_detector_openvino,
                    )

                    variables, _ = convert_detector_openvino(
                        args.input, bin_path, cfg
                    )
        elif args.input.endswith(".onnx"):
            if variant is not None:
                from litepi_tpu_torch.weights.onnx_import import (
                    read_onnx_initializers,
                )

                variables = _variant_convert_sd(
                    read_onnx_initializers(args.input)
                )
            elif is_detector:
                from litepi_tpu_torch.weights.onnx_import import (
                    convert_detector_onnx,
                )

                variables = convert_detector_onnx(args.input, cfg.depths)
            else:
                from litepi_tpu_torch.weights.onnx_import import (
                    convert_classifier_onnx,
                    convert_classifier_onnx_fused,
                    convert_classifier_onnx_traced,
                )

                fused_result = None
                if args.arch == "shufflenetv2":
                    # a fused emission re-ingests as deploy form by NAME;
                    # a real torch.onnx.export fused graph (anonymous
                    # onnx::Conv_* initializers) binds by TOPOLOGY; fall
                    # back to the name-preserving converter for unfused
                    # exports
                    try:
                        fused_result = convert_classifier_onnx_fused(
                            args.input
                        )
                    except ValueError:
                        try:
                            fused_result = convert_classifier_onnx_traced(
                                args.input
                            )
                        except ValueError:
                            fused_result = None
                if fused_result is not None:
                    variables, ncls = fused_result
                    if ncls != args.num_classes:
                        raise ValueError(
                            f"graph has {ncls} classes, --num_classes "
                            f"says {args.num_classes}"
                        )
                else:
                    variables = convert_classifier_onnx(args.arch, args.input)
        else:
            from litepi_tpu_torch.weights.torch_import import (
                convert_classifier_state_dict,
                convert_detector_state_dict,
                load_torch_state_dict,
            )

            sd = load_torch_state_dict(args.input)
            if variant is not None:
                variables = _variant_convert_sd(sd)
            elif is_detector:
                # tolerate fused exports saved back to .pth (identity-BN
                # rebuild is a no-op for ordinary unfused dicts)
                from litepi_tpu_torch.weights.onnx_import import defuse_state_dict

                variables = convert_detector_state_dict(
                    defuse_state_dict(sd), cfg.depths
                )
            else:
                variables = convert_classifier_state_dict(args.arch, sd)
    # a missing/mispaired .bin, a graph that fails topology verification,
    # or a state dict from a different architecture all surface here —
    # keep the CLI's pointed-error contract (rc 2, no traceback)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {args.input}: {e}", file=sys.stderr)
        return 2

    # ---- export smoke test --------------------------------------------- #
    try:
        ok, sample = _smoke(args, variables, cfg, variant, is_detector, dev)
    # a checkpoint from a different architecture surfaces here (missing /
    # mis-shaped parameters in load_state_dict) — keep the pointed-error
    # contract
    except (ValueError, KeyError, TypeError, RuntimeError) as e:
        print(
            f"error: {args.input}: converted variables do not fit "
            f"{args.arch!r} ({e})",
            file=sys.stderr,
        )
        return 2

    if not ok:
        print("error: converted model failed the smoke test", file=sys.stderr)
        return 1

    if args.emit == "onnx":
        import dataclasses
        import os

        from litepi_tpu_torch.weights.onnx_import import read_onnx_initializers

        if args.output.endswith(".onnx"):
            onnx_out = args.output
            os.makedirs(os.path.dirname(onnx_out) or ".", exist_ok=True)
        else:
            os.makedirs(args.output, exist_ok=True)
            onnx_out = os.path.join(args.output, "model.onnx")
        try:
            if not is_detector:
                from litepi_tpu_torch.weights.onnx_export import (
                    export_classifier_onnx,
                )

                data = export_classifier_onnx(
                    args.arch, variables, args.num_classes, onnx_out,
                    input_size=args.input_size,
                )
            else:
                from litepi_tpu_torch.weights.onnx_export import (
                    export_detector_onnx,
                )

                data = export_detector_onnx(
                    variables,
                    dataclasses.replace(cfg, input_size=args.emit_input_size),
                    onnx_out,
                )
        except (ValueError, KeyError) as e:
            print(f"error: --emit onnx: {e}", file=sys.stderr)
            return 2
        # deserialization smoke: our own reader must recover initializers
        if not read_onnx_initializers(data):
            print("error: emitted ONNX has no initializers", file=sys.stderr)
            return 1
        print(
            f"exported {args.input} ({args.arch}, {args.num_classes} "
            f"classes) -> {onnx_out}; "
            f"smoke sample={np.round(sample, 4).tolist()}"
        )
        return 0

    if args.emit == "openvino":
        import dataclasses
        import os

        from litepi_tpu_torch.weights.openvino_export import (
            export_detector_openvino,
        )
        from litepi_tpu_torch.weights.openvino_import import (
            openvino_state_dict,
            verify_openvino_topology,
        )

        if args.output.endswith(".xml"):
            xml_out = args.output
            os.makedirs(os.path.dirname(xml_out) or ".", exist_ok=True)
        else:
            os.makedirs(args.output, exist_ok=True)
            xml_out = os.path.join(args.output, "model.xml")
        bin_out = xml_out[: -len(".xml")] + ".bin"
        try:
            if not is_detector:
                from litepi_tpu_torch.weights.openvino_export import (
                    export_classifier_openvino,
                )

                export_classifier_openvino(
                    args.arch, variables, args.num_classes, xml_out,
                    bin_out, input_size=args.input_size,
                )
            elif variant is not None:
                from litepi_tpu_torch.weights.openvino_export import (
                    export_detector_openvino_variant,
                )

                export_detector_openvino_variant(
                    variables, variant, xml_out, bin_out,
                    num_classes=args.num_classes,
                    input_size=args.emit_input_size,
                )
            else:
                emit_cfg = dataclasses.replace(
                    cfg, input_size=args.emit_input_size
                )
                export_detector_openvino(variables, emit_cfg, xml_out, bin_out)
        except (ValueError, KeyError) as e:
            print(f"error: --emit openvino: {e}", file=sys.stderr)
            return 2
        # deserialization smoke: the emitted IR must pass our own topology
        # verifier and yield a readable weight set
        if not is_detector:
            from litepi_tpu_torch.weights.openvino_import import (
                convert_classifier_openvino_fused,
            )

            _, smoke_nc = convert_classifier_openvino_fused(xml_out, bin_out)
            if smoke_nc != args.num_classes:
                print(
                    f"error: emitted IR re-ingests with {smoke_nc} classes",
                    file=sys.stderr,
                )
                return 1
        elif variant is not None:
            from litepi_tpu_torch.weights.openvino_import import (
                verify_openvino_variant_topology,
            )

            verify_openvino_variant_topology(
                xml_out, variant, args.num_classes
            )
        else:
            verify_openvino_topology(xml_out, emit_cfg)
        if is_detector and not openvino_state_dict(xml_out, bin_out):
            print("error: emitted IR has no weight Consts", file=sys.stderr)
            return 1
        if not args.output.endswith(".xml"):
            _write_ncnn_metadata(args, cfg)
        print(
            f"exported {args.input} ({args.arch}, {args.num_classes} "
            f"classes) -> {xml_out} + .bin; "
            f"smoke sample={np.round(sample, 4).tolist()}"
        )
        return 0

    if args.emit == "ncnn":
        import os

        from litepi_tpu_torch.weights.ncnn_export import export_detector_ncnn
        from litepi_tpu_torch.weights.ncnn_import import (
            parse_ncnn_param,
            read_ncnn_bin,
        )

        os.makedirs(args.output, exist_ok=True)
        param_out = os.path.join(args.output, "model.ncnn.param")
        bin_out = os.path.join(args.output, "model.ncnn.bin")
        try:
            if not is_detector:
                from litepi_tpu_torch.weights.ncnn_export import (
                    export_classifier_ncnn,
                )

                export_classifier_ncnn(
                    args.arch, variables, args.num_classes, param_out,
                    bin_out, dtype=args.emit_dtype,
                )
            elif variant is not None:
                from litepi_tpu_torch.weights.ncnn_export import (
                    export_detector_ncnn_variant,
                )

                export_detector_ncnn_variant(
                    variables, variant, param_out, bin_out,
                    num_classes=args.num_classes, dtype=args.emit_dtype,
                    input_size=args.emit_input_size,
                )
            else:
                import dataclasses

                export_detector_ncnn(
                    variables,
                    dataclasses.replace(
                        cfg, input_size=args.emit_input_size
                    ),
                    param_out, bin_out, dtype=args.emit_dtype,
                )
        # unfoldable BN state / wrong-architecture variables surface here
        except (ValueError, KeyError) as e:
            print(f"error: --emit ncnn: {e}", file=sys.stderr)
            return 2
        # deserialization smoke: the emitted pair must parse and re-read
        # cleanly (build_detector_graph already topology-verified the graph)
        read_ncnn_bin(parse_ncnn_param(param_out), bin_out)
        _write_ncnn_metadata(args, cfg)
        _write_ncnn_smoke_script(args)
        print(
            f"exported {args.input} ({args.arch}, {args.num_classes} "
            f"classes) -> {param_out} + .bin ({args.emit_dtype}); "
            f"smoke sample={np.round(sample, 4).tolist()}"
        )
        return 0

    save_checkpoint(args.output, variables)
    print(
        f"converted {args.input} ({args.arch}, {args.num_classes} classes) "
        f"-> {args.output}; smoke sample={np.round(sample, 4).tolist()}"
    )
    return 0


def _smoke(args, variables, cfg, variant, is_detector, dev):
    """(ok, sample): a seeded input through the port's model on ``dev``
    (float32, TF32 off): a detector's head output, or a classifier's
    logits, finite and of the right shape; ``sample`` holds the first three
    class logits (the JAX CLI's ``smoke sample``)."""
    import numpy as np
    import torch

    from litepi_tpu_torch.weights.graph_ops import float32_exact
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    rng = np.random.default_rng(0)
    if is_detector:
        size = max(args.input_size, 64)  # detector stride 32 floor
        if variant == "yolov5nu":
            from litepi_tpu_torch.models.yolov5 import YoloV5

            model = YoloV5(num_classes=args.num_classes, anchor_free=True)
        elif variant == "yolov11n":
            from litepi_tpu_torch.models.yolov11 import YoloV11

            model = YoloV11(num_classes=args.num_classes)
        else:
            from litepi_tpu_torch.models import YoloLitePi

            model = YoloLitePi(cfg)  # num_classes already folded in
        smoke_vars = variables
    else:
        from litepi_tpu_torch.models import build_classifier
        from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS
        from litepi_tpu_torch.weights.fold_bn import fold_pipeline_vars

        # deploy-form variables (NCNN-ingested, pre-folded checkpoints)
        # smoke-test through the fused module form
        smoke_vars, fused = fold_pipeline_vars(variables, eps=CLASSIFIER_BN_EPS)
        model = build_classifier(args.arch, args.num_classes, fused=fused)
        size = args.input_size
    model.load_state_dict(jax_to_state_dict(smoke_vars))
    model = model.eval().to(dev)
    x = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    with float32_exact():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(dev))
    if is_detector:
        cls, reg = out["cls"].cpu().numpy(), out["reg"].cpu().numpy()
        n_anchors = sum((size // s) ** 2 for s in (8, 16, 32))
        ok = (
            cls.shape == (1, n_anchors, args.num_classes)
            and np.isfinite(cls).all() and np.isfinite(reg).all()
        )
        return ok, cls[0, :3, 0]
    logits = out.cpu().numpy()
    ok = logits.shape == (1, args.num_classes) and np.isfinite(logits).all()
    return ok, logits[0, :3]


def _write_ncnn_smoke_script(args) -> None:
    """Sidecar ``model_ncnn.py`` — every pnnx export in the reference
    ships one (seeded input -> print out0, model_ncnn.py:5-26); this
    equivalent runs on the deployment box (needs the ``ncnn`` wheel there)
    so the emitted pair can be smoke-tested where it will serve."""
    import os

    is_detector = args.arch not in CLASSIFIER_ARCHS
    size = args.emit_input_size if is_detector else args.input_size
    script = f'''"""Seeded-input smoke test for this litepi_tpu NCNN export.

Run on the deployment machine (requires the `ncnn` python wheel):
prints the graph's out0 for a fixed random input, so two boxes (or a
box and the exporting framework) can compare numbers.
"""

import numpy as np

import ncnn


def test_inference():
    rng = np.random.default_rng(0)
    x = rng.random((3, {size}, {size}), dtype=np.float32)
    with ncnn.Net() as net:
        net.load_param("model.ncnn.param")
        net.load_model("model.ncnn.bin")
        with net.create_extractor() as ex:
            ex.input("in0", ncnn.Mat(x))
            _, out0 = ex.extract("out0")
            out = np.array(out0)
    print("out0", out.shape, out.reshape(-1)[:8])
    return out


if __name__ == "__main__":
    test_inference()
'''
    with open(os.path.join(args.output, "model_ncnn.py"), "w") as f:
        f.write(script)


def _write_ncnn_metadata(args, cfg) -> None:
    """Sidecar metadata.yaml with the reference export's field set
    (src/*/convert/model/*/metadata.yaml: stride/task/imgsz/names)."""
    import datetime
    import os

    is_detector = args.arch not in CLASSIFIER_ARCHS
    name = cfg.name if cfg is not None else args.arch
    size = args.emit_input_size if is_detector else args.input_size
    task = "detect" if is_detector else "classify"
    names = "\n".join(
        f"  {i}: class{i}" for i in range(args.num_classes)
    )
    with open(os.path.join(args.output, "metadata.yaml"), "w") as f:
        f.write(
            f"description: litepi_tpu {name} export of {args.input}\n"
            "author: litepi_tpu\n"
            f"date: '{datetime.datetime.now().isoformat()}'\n"
            f"task: {task}\n"
            + ("stride: 32\n" if is_detector else "")
            + "batch: 1\n"
            f"imgsz:\n- {size}\n- {size}\n"
            f"names:\n{names}\n"
            "channels: 3\n"
        )


if __name__ == "__main__":
    sys.exit(main())
