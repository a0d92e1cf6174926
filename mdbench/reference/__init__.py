"""Plain PyTorch references of what the cells' analyses compute.

Each kind is a file of its own, ``<kind>.py``, with

* ``expected(frames, dimensions, spec, device, dtype)``: the answer for
  float32 ``frames`` ``(T, N, 3)`` (numpy, wrapped into the box) and the
  analysis's entry `spec` of the traffic file, computed in `dtype`
  (float64; a lower precision for the control);
* ``judge(taken, want)``: the numbers compared, ``{name: value}``, of the
  program's results `taken` (the arrays its entry's ``take`` names)
  against `want`.

The references import nothing of the program.  They take the generated
frames, as the program does, and work out the unwrapping and the
wavevectors again themselves.
"""
