"""Training data: the synthetic world (``synthetic``, over ``image_ops``),
datasets over image files (``datasets``, ``png``, ``cv_resize``) with
their host augmentation (``augment``, ``ssd_augment``), the host loader
and device prefetch (``loader``), device-resident pools (``device_data``)
and on-device augmentation (``device_augment``, ``ssd_device``)
(counterpart of ``loans_tpu.data``)."""
