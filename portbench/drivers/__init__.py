"""The general generators that traffic mixes name (`"driver"` in a mix's
file): each makes a cell's inputs from the seed, sets up the port, drives
its entry point for one window, and checks what the window produced
against the reference."""
