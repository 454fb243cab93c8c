"""Model zoo of the port: registry, decoder, param conversion, checkpoint loading."""
