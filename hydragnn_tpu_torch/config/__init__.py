from hydragnn_tpu_torch.config.config import (
    load_config,
    merge_config,
    normalize_output_heads,
    save_config,
    update_config,
)
