"""The datagrams the host dropped for a full receive buffer while the
window's frames were sent and shown: the host's ``RcvbufErrors``
(/proc/net/snmp) at the receiver's end less its count as the window opened,
both read by the receiver's process (``ugbench/child.py``).  A configuration
whose receive buffer is smaller than a frame with its parity relies on the
receiver draining the paced datagrams as they come: a loss there shows
here before it costs a frame.  The session's are the only UDP receivers on
the benchmark's machine.  None where the host does not give the count."""


def read(run):
    ch = run.get("child") or {}
    end, at_window = ch.get("rcvbuf_errors"), ch.get("rcvbuf_errors_at_window")
    if end is None or at_window is None or end < 0 or at_window < 0:
        return None
    return float(end - at_window)
