"""AMP op lists: the per-op dtype policy as data (a copy of the
reference package's ``amp/amp_lists.py``; names are the reference's op
names).

- WHITE: matmul-class ops, run in the autocast dtype.
- BLACK: numerically sensitive ops (losses, the log/exp family, long
  reductions), run in float32.
- every other op runs in whatever dtype its inputs carry.
"""

WHITE_LIST = {
    "matmul", "mm", "bmm", "addmm", "mv", "einsum", "multi_dot",
    "linear", "fused_linear",
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "flash_attention", "scaled_dot_product_attention",
}

BLACK_LIST = {
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "kl_div",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "sigmoid_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "ctc_loss", "margin_cross_entropy",
    # log/exp family
    "log", "log2", "log10", "log1p", "exp", "expm1", "pow",
    "logsumexp", "log_softmax", "softmax",
    # long reductions / norms (bf16 accumulation drifts)
    "sum", "mean", "cumsum", "norm", "p_norm", "var", "std", "dist",
    "erfinv", "cosh", "sinh", "acos", "asin",
}


def white_list(custom_white=None, custom_black=None):
    w = set(WHITE_LIST)
    if custom_white:
        w |= set(custom_white)
    if custom_black:
        w -= set(custom_black)
    return w


def black_list(custom_white=None, custom_black=None):
    b = set(BLACK_LIST)
    if custom_black:
        b |= set(custom_black)
    if custom_white:
        b -= set(custom_white)
    return b
