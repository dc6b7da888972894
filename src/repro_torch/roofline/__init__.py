from .analysis import (
    PEAKS,
    CardPeaks,
    RooflineTerms,
    StepTrace,
    analyze_step,
    card_peaks,
    count_params,
    flash_decode_cost,
    model_flops,
    ssd_cost,
    trace_step,
)

__all__ = ["PEAKS", "CardPeaks", "RooflineTerms", "StepTrace", "analyze_step", "card_peaks",
           "count_params", "flash_decode_cost", "model_flops", "ssd_cost", "trace_step"]
