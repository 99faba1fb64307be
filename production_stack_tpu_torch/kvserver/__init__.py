"""The remote KV block store, its sharded client and the cache controller,
on the standard library's ``http.server`` (the JAX package's aiohttp
kvserver and controller, speaking their wire format byte for byte)."""
