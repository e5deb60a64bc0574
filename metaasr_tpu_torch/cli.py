"""Command line for the port (counterpart of ``metaasr_tpu/cli.py``); this
slice has the serving mode only:

    python -m metaasr_tpu_torch.cli --mode serve --bundle DIR \
        --config configs/config3_fomaml.yaml --wav a.wav [b.wav ...]

The bundle is one the JAX package exported (``--mode export``) or one
``serve.export.write_bundle`` wrote; ``--config`` supplies what the bundle
does not record (model dims and dtype, CMVN mode, beam options). Runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

from metaasr_tpu_torch.config import load_config


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return key, val.lower() == "true"
    return key, val


def main(argv=None):
    p = argparse.ArgumentParser("metaasr_tpu_torch")
    p.add_argument("--mode", choices=["serve"], default="serve")
    p.add_argument("--config", type=str, default=None,
                   help="the run's YAML config (defaults: Config())")
    p.add_argument("--bundle", type=str, required=True,
                   help="serving bundle directory")
    p.add_argument("--wav", nargs="+", required=True,
                   help="WAV files to transcribe")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path)")
    p.add_argument("--serve-params", type=str, default=None,
                   help="hot-swap an adapted params npz (flat a/b/c keys, "
                   "Flax layout)")
    p.add_argument("--serve-out", type=str, default=None,
                   help="also write one JSONL record per file here")
    p.add_argument("--dump-nbest", type=int, default=1,
                   help="hypotheses (with scores) per utterance")
    p.add_argument("-o", "--override", action="append", default=[],
                   help="dotted config override key=value")
    args = p.parse_args(argv)

    from metaasr_tpu_torch.serve.export import ServingDecoder, load_bundle_params

    overrides = dict(_parse_override(kv) for kv in args.override)
    cfg = load_config(args.config, overrides)
    dec = ServingDecoder(args.bundle, cfg, device=args.device)
    params = (load_bundle_params(args.serve_params)
              if args.serve_params else None)
    results = dec.transcribe_files(args.wav, params=params,
                                   nbest=args.dump_nbest)
    lines = [json.dumps({"file": path, **r})
             for path, r in zip(args.wav, results)]
    for line in lines:
        print(line)
    if args.serve_out:
        with open(args.serve_out, "w") as f:
            f.writelines(line + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
