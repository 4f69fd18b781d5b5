"""Observability of the localizer (counterpart of ``loans_tpu.insights``):
VisualBackprop heat maps (``visual_backprop``), prediction renders in numpy
with score text through Pillow (``rendering``), the per-iteration
BBoxPlotter (``bbox_plotter``), the progress stream and its server
(``progress_server``) and the GIF and video of the renders (``media``)."""
