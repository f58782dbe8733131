"""Model zoo of the port: configs become parameter trees, forward,
prefill and decode (dense decoders so far)."""
