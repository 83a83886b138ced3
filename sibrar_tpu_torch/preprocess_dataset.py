"""Preprocessing CLI of the port: a raw dataset directory in, the split
artifacts out (port of the repository root's ``preprocess_dataset.py``,
with its arguments, plus ``--device``).

The config is a YAML of `preprocessing.ppconfig.PreprocessingConfig`
(split ratios / type / seed, interaction filters, each feature's
preprocessing and normalization steps). The interaction stages run on the
card unless ``--device cpu``; stdout is tee'd to
``preprocess_{id}.log`` in the output directory, with one line of stage
times (seconds) at the end.

    python -m sibrar_tpu_torch.preprocess_dataset -d /raw/onion18_parsed \\
        -o /data/onion18 -c conf/preprocessing/onion18.yml [-s coldstart \\
        --cold_start_type item] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.config.loader import load_config_dict
from sibrar_tpu_torch.preprocessing.filtering import as_device
from sibrar_tpu_torch.preprocessing.pipeline import load_raw, preprocess, timed
from sibrar_tpu_torch.preprocessing.ppconfig import PreprocessingConfig
from sibrar_tpu_torch.utils.misc import Tee, generate_id


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="sibrar_tpu_torch dataset preprocessing")
    parser.add_argument("--data_dir", "-d", required=True,
                        help="raw dataset directory (listening_history.csv "
                             "+ features)")
    parser.add_argument("--out_dir", "-o", required=True,
                        help="output base directory (the split's "
                             "subdirectory is created inside)")
    parser.add_argument("--conf_path", "-c", default=None,
                        help="preprocessing yaml (default config if "
                             "omitted)")
    parser.add_argument("--split_type", "-s", default=None,
                        choices=("random", "temporal", "coldstart"))
    parser.add_argument("--cold_start_type", default=None,
                        choices=("user", "item", "both"))
    parser.add_argument("--device", default="cuda",
                        help="device of the interaction stages: cuda (the "
                             "card, the default) or cpu")
    args = parser.parse_args(argv)

    conf_dict = load_config_dict(args.conf_path) if args.conf_path else {}
    if args.split_type:
        conf_dict.setdefault("split", {})["split_type"] = args.split_type
    if args.cold_start_type:
        conf_dict.setdefault("split", {})["cold_start_type"] = \
            args.cold_start_type
    config = config_from_dict(PreprocessingConfig, conf_dict)
    dev = as_device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    log_file = os.path.join(args.out_dir, f"preprocess_{generate_id()}.log")
    timings: dict = {}
    with Tee(log_file):
        with timed(timings, "read", dev):
            raw = load_raw(args.data_dir, config)
        preprocess(raw, config, out_base=args.out_dir, device=dev,
                   timings=timings)
        print("preprocess stage seconds on " + str(dev) + ": "
              + json.dumps(timings))
    return timings


if __name__ == "__main__":
    main()
