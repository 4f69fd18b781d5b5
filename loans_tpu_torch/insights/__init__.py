"""Observability of the localizer: VisualBackprop heat maps
(``visual_backprop``) and prediction renders without Pillow
(``rendering``) (counterpart of ``loans_tpu.insights``; the BBoxPlotter,
the media helpers and the progress server are ROADMAP.md Queue 1 item 13)."""
