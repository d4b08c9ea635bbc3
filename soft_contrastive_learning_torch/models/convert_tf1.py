"""TF1 checkpoint export -> flax-path parameter tree, the port's own copy of
``soft_contrastive_learning_tpu/models/convert_tf1.py`` (numpy only; the
port imports nothing of the JAX package).

The reference warm-starts from (and publishes) TF1 checkpoints whose
variables live under the ``vgg16_netvlad_pca`` scope with matconvnet-
compatible names. The port reads them as an ``.npz`` of
{tf_variable_name: array}, exported on any machine with TensorFlow::

    import tensorflow as tf, numpy as np
    r = tf.train.load_checkpoint(CKPT)
    np.savez(OUT, **{n: r.get_tensor(n) for n in r.get_variable_to_shape_map()})

A raw TF checkpoint path is refused with the JAX module's message: the
card's machine has no TensorFlow.

Name mapping (TF -> flax path):
  vgg16_netvlad_pca/average_rgb            -> vgg16/average_rgb
  vgg16_netvlad_pca/convX_Y/kernel|bias    -> vgg16/blockX/convX_Y/kernel|bias
  vgg16_netvlad_pca/assignment/kernel      -> netvlad/assignment/kernel
  vgg16_netvlad_pca/cluster_centers        -> netvlad/cluster_centers (squeezed
                                              from (1,1,1,D,K) to (D,K))
  fcN/dense*/kernel|bias                   -> fc_head/fcN/kernel|bias
Conv kernels keep TF's (kh, kw, in, out) layout, which is flax's;
``flatten`` gives the slash-keyed dict ``models/weights.py::params_from_flax``
turns into the port's state dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

_SCOPE = "vgg16_netvlad_pca"
_CONV = re.compile(r"^conv(\d)_(\d)/(kernel|bias)$")
_FC = re.compile(r"^fc(\d)(?:/dense(?:_\d+)?)?/(kernel|bias)$")


def load_tf1_variables(path: str) -> Dict[str, np.ndarray]:
    """{name: array} from an ``.npz`` export; anything else raises."""
    if not str(path).endswith(".npz"):
        raise RuntimeError(
            "tensorflow unavailable: export the checkpoint to .npz first "
            "(see models/convert_tf1.py docstring)")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _strip(name: str) -> str:
    name = name.split(":")[0]
    prefix = _SCOPE + "/"
    return name[len(prefix):] if name.startswith(prefix) else name


def convert_tf1_variables(
    tf_vars: Mapping[str, np.ndarray],
) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Map TF1 variables into an EmbeddingNet params tree. Returns (params,
    mapping), mapping tf_name -> flax path. Unrecognized variables
    (optimizer slots, the global step) are skipped."""
    vgg: Dict[str, Any] = {}
    netvlad: Dict[str, Any] = {}
    fc: Dict[str, Any] = {}
    mapping: Dict[str, str] = {}
    for raw_name, value in tf_vars.items():
        name = _strip(raw_name)
        value = np.asarray(value)
        m = _CONV.match(name)
        if m:
            block, conv = f"block{m.group(1)}", f"conv{m.group(1)}_{m.group(2)}"
            vgg.setdefault(block, {}).setdefault(conv, {})[m.group(3)] = value
            mapping[raw_name] = f"vgg16/{block}/{conv}/{m.group(3)}"
        elif name == "average_rgb":
            vgg["average_rgb"] = value.reshape(3)
            mapping[raw_name] = "vgg16/average_rgb"
        elif name == "assignment/kernel":
            netvlad.setdefault("assignment", {})["kernel"] = value
            mapping[raw_name] = "netvlad/assignment/kernel"
        elif name == "cluster_centers":
            netvlad["cluster_centers"] = value.reshape(value.shape[-2], value.shape[-1])
            mapping[raw_name] = "netvlad/cluster_centers"
        else:
            m = _FC.match(name)
            if m:
                layer = f"fc{m.group(1)}"
                fc.setdefault(layer, {})[m.group(2)] = value
                mapping[raw_name] = f"fc_head/{layer}/{m.group(2)}"
    params: Dict[str, Any] = {}
    for scope, tree in (("vgg16", vgg), ("netvlad", netvlad), ("fc_head", fc)):
        if tree:
            params[scope] = tree
    return params, mapping


def convert_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, str]]:
    return convert_tf1_variables(load_tf1_variables(path))


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested params tree -> {slash path: array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat
