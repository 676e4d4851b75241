"""The workflow commands' figures (``viz/plots.py``); matplotlib loads only
when a figure is drawn."""
