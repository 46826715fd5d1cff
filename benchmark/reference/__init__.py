"""Plain PyTorch reference of the map update (no kernel of the program, no
import of it), with the replays that decide whether a run is correct."""
