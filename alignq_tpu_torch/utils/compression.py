"""Compression rate of the conv weights (port of
alignq_tpu/utils/compression.py): 32 * conv params over the quantized
bits, the first conv's bits left out (the reference's convs[1:]) unless
include_first.

The convs are the 4-D `kernel` leaves of the params tree in the JAX
package's order and under its path strings: a flax tree's keys sorted at
every level ('layers_10' before 'layers_2'), joined by '/'
('layers_0/conv1/kernel'). A model is read through interop.deploy_tree,
which gives its parameters flax's names and layout (a depthwise kernel
(C, 1, 3, 3) as (3, 3, 1, C)), so the same conv is the first one dropped
and a bits_fn written for the JAX package gets the same paths.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in jax.tree_util's order: dict keys sorted, list items
    in order under '[i]'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def compression_info(
    model_or_tree: Any,
    w_bit: int = 8,
    bits_fn: Optional[Callable[[str], int]] = None,
    include_first: bool = False,
) -> dict:
    """{conv_params, fp32_bits, quant_bits, compression_rate,
    num_conv_layers} of a torch model or a flax-layout params tree (nested
    dicts of tensors or arrays). bits_fn: path -> bits (mixed precision),
    else w_bit for every conv."""
    tree = model_or_tree
    if hasattr(model_or_tree, "named_parameters"):
        from alignq_tpu_torch.interop import deploy_tree

        tree = deploy_tree(model_or_tree)[0]
    convs = [(path, tuple(leaf.shape)) for path, leaf in _paths(tree)
             if path.split("/")[-1] == "kernel" and len(getattr(leaf, "shape", ())) == 4]
    counted = convs if include_first else convs[1:]
    total_params = sum(int(np.prod(shape)) for _, shape in convs)
    total_bits = sum(int(np.prod(shape)) * (bits_fn(path) if bits_fn else w_bit) for path, shape in counted)
    fp32_bits = total_params * 32
    return {
        "conv_params": total_params,
        "fp32_bits": fp32_bits,
        "quant_bits": total_bits,
        "compression_rate": fp32_bits / max(total_bits, 1),
        "num_conv_layers": len(convs),
    }
