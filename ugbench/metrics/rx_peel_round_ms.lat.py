"""One round of the receiver's peel (``ops/fec.py``
``LdgmSession.decode_device``): K2 and the host's read of the round's flag,
the program's ``fec.peel.round`` span inside ``rx.fec``, mean ms a round
in the window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "fec.peel.round")
