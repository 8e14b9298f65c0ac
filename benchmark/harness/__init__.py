"""The benchmark's own code: the cells' set-up and step (cell.py), the
inputs made from the seed (inputs.py), the numbers compared against the
plain reference (numbers.py), the traced window (profile.py), the card's
timing helpers (timing.py) and the roofline arithmetic (roofline.py)."""
