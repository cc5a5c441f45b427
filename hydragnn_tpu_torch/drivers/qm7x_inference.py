"""QM7-X inference: predict fresh conformations from the trained checkpoint.

Counterpart of ``examples/qm7x/inference.py``: ``run_prediction`` with
qm7x.json (or, with ``--mlip``, qm7x_mlip.json) restores the checkpoint
that ``qm7x`` saved under ``logs/<log_name>`` in the working directory
and reports the test split's error, per head, over ``build_dataset``'s
frames. The log name holds ``num_epoch``, so ``--epochs`` must be the
training run's.

    python -m hydragnn_tpu_torch.drivers.qm7x --mlip --epochs 5
    python -m hydragnn_tpu_torch.drivers.qm7x_inference --mlip --epochs 5
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.qm7x import CONFIGS, build_dataset


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], *CONFIGS)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=10,
                    help="num_epoch the training run had (part of the checkpoint's log name)")
    args = ap.parse_args(argv)
    dev = common.device(args)

    import hydragnn_tpu_torch as port

    config = common.example_config(args)
    splits = common.split(build_dataset(args.frames))
    error, per_task, true, pred = port.run_prediction(config, datasets=tuple(splits),
                                                      device=dev)
    print(f"inference error {float(error):.5f}")
    heads = [float(t) for t in np.asarray(per_task).reshape(-1)]
    for i, t in enumerate(heads):
        print(f"  head {i}: {t:.5f}")
    print(f"collected {len(true[0])} true/pred samples")
    return {"error": float(error), "heads": heads, "samples": len(true[0])}


if __name__ == "__main__":
    main()
