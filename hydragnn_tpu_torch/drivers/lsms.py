"""LSMS raw files through the full ``Dataset.path`` ingestion.

Counterpart of ``examples/lsms/lsms.py``: lsms.json trained on
LSMS-format text files the way a user with LSMS output directories
trains (format detection, raw reading, normalization statistics, radius
graphs and the split all inside ``run_training``). Without
``--data_dir`` the deterministic synthetic BCC set
(``data/synthetic.deterministic_graph_data``, seed 3) is written into a
temporary directory, removed after the run.

    python -m hydragnn_tpu_torch.drivers.lsms --configs 200 --epochs 10
    python -m hydragnn_tpu_torch.drivers.lsms --device cpu --configs 60 --epochs 2
"""

from __future__ import annotations

import os
import tempfile

from hydragnn_tpu_torch.drivers import common


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("lsms", "lsms.json"))
    ap.add_argument("--configs", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--data_dir", default=None, help="existing LSMS dir (else synthesized)")
    args = ap.parse_args(argv)
    dev = common.device(args)

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    config = common.example_config(args)
    with tempfile.TemporaryDirectory(prefix="lsms_demo_") as tmp:
        data_dir = args.data_dir
        if data_dir is None:
            data_dir = os.path.join(tmp, "unit_test")
            deterministic_graph_data(data_dir, number_configurations=args.configs, seed=3)
        config["Dataset"]["path"] = {"total": data_dir}
        state, model, cfg, hist, _ = port.run_training(config, seed=0, device=dev)
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
