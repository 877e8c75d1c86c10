"""The modes a traffic file's `mode` names, one file each:
`benchmark/modes/<mode>.py`, found by that name (`cells.load_mode`).

A mode module has

- `run(cell, cfg, values, seed, seconds, trace, device, mark_window,
  fault=None) -> runs.Run`: build the program from the seed, warm up the
  cell's own shapes, call ``mark_window()`` and measure for ``seconds``,
  with ``trace`` trace a short stretch after the window, free the program
  and run the output check; the `Run` holds the end-to-end metrics the
  mode reports (all but `setup_s`), the readers' context and the check's
  numbers;
- `control(cell, seed, device) -> dict(numbers=..., detail=...)`: the
  check's numbers of the control, the reference computed in the
  precision below the configuration's in the program's place.
"""
