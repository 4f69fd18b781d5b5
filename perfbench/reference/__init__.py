"""The plain float32 reference of each configuration: plain PyTorch
operations written from the published descriptions, with no kernel and
nothing of the program (it imports neither ``loans_tpu`` nor
``loans_tpu_torch``). Parameter names follow the program's ``state_dict``
keys, so that one seeded state dict loads into both."""
