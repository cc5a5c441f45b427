from hydragnn_tpu_torch.postprocess.postprocess import output_denormalize


def __getattr__(name):
    # Lazy: Visualizer pulls in matplotlib, which output_denormalize
    # consumers should not need.
    if name == "Visualizer":
        from hydragnn_tpu_torch.postprocess.visualizer import Visualizer

        return Visualizer
    raise AttributeError(name)
