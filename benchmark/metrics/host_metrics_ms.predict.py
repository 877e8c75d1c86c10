"""host_metrics_ms.predict: host ms a scene of `evaluate_scenes`' metrics
after each predict (PSNR, SSIM, the MVS depth RMSE; the
`evaluate.host_metrics` span)."""
from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "predict", "evaluate.host_metrics")
