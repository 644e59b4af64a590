"""Load drivers: a traffic file names one (``"driver"``), and
``portbench/drivers/<driver>.py`` holds a ``Driver`` class that sets the
cell up, drives the program for a window, and checks what the window
produced against the reference."""
