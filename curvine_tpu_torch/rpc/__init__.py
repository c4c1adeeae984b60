"""The port's own copy of the cache's RPC layer, client side: the wire
codec (``wirepack``), operation codes, framing and connections."""
