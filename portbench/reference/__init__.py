"""The plain reference that decides ``correct``: the frozen copy of the
simulator and the model (``frozen/``), the fleet's tick followed from the
program's state (``sim.py``) and the first train steps (``train.py``). Nothing
here imports the program."""
