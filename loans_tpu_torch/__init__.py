"""loans_tpu_torch — the Localizer-Assessor Networks in PyTorch.

A port of ``loans_tpu`` (JAX/Pallas) to PyTorch and CUDA on NVIDIA Hopper.
The sub-layout mirrors ``loans_tpu`` so each module's counterpart is found
under the same path:

* ``ops``: geometry, rotation dropout and the spatial transformer, whose
  axis-aligned crop runs on the card as a hand-written CUDA kernel
  (``ops/csrc/separable_sampler.cu``) beside its plain PyTorch version;
* ``models``: the scratch ResNet, the Localizer and the ResnetAssessor;
* ``bridge``: JAX/flax variables -> PyTorch ``state_dict``;
* ``train.checkpoint``, ``utils.registry``: log-dir manifests and
  ``<Name>_<iter>.pt`` snapshots;
* ``inference.localizer``: ``LocalizerInference``;
* ``data``, ``evaluation``, ``train``: the synthetic world without Pillow,
  device pools, in-training mAP, the steps and the trainer;
* ``cli.image_inference``, ``cli.train_localizer``: the image and training
  CLIs.

Public boundaries keep the JAX package's conventions: images are NHWC
float in [0, 1] RGB, theta is (N, 2, 3), corners are [tl, tr, bl, br] and
boxes are (y_min, x_min, y_max, x_max). Inside, modules run NCHW.

The package imports ``torch`` and ``numpy`` only; importing it builds
nothing. CUDA kernels are compiled at first use (``ops/_cuda.py``).
"""

__version__ = "0.1.0"
