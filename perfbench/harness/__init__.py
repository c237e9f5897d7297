"""The benchmark's yardstick: cell lookup, weights and batches from the
seed, spans and the device trace, the table of peaks, and the judge."""
