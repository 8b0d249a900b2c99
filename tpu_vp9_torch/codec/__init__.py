"""Frame-level codec logic: mode-info grids, partition/mode syntax,
block walking, and the frame encoders/decoder built on ops + bitstream.
"""
