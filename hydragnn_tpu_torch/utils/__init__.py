from hydragnn_tpu_torch.utils.time_utils import Timer, print_timers
