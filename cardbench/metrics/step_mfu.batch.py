"""The whole step's share of the card's bf16 peak: model FLOPs per frame
(the reference detector on one frame and the classifier on the budget's
crops per frame, counted by FlopCounterMode) times frames per second
in the untraced part of the window, over 989 TFLOP/s."""
from cardbench import yardstick


def read(run):
    if not run.get("flops_per_frame"):
        return None
    return 100.0 * run["flops_per_frame"] * run["frames_per_s"] / yardstick.BF16_FLOPS
