"""Information-Bottleneck LDPC decoding framework in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
reference repo ``mx-strk/InformationBottleneckDecodingLDPC`` (see SURVEY.md):

- ``codes``      parity-check matrices: AList/.npy/.npz loaders, 802.11n and
                 DVB-S2-style constructors, Tanner-graph edge layouts.
- ``ib``         information-bottleneck algorithms (symmetric sequential IB and
                 an exact dynamic-programming variant) + info-theory tools.
                 Replaces the reference's external ``information_bottleneck``
                 (ib_base) dependency.
- ``channel``    BPSK mapping, AWGN channel, information-optimum channel
                 output quantizer (all on-device, ``jax.random`` PRNG).
- ``encode``     GF(2) encoder (host factorization once; batched XOR
                 substitution in C++ and jittable device encoders).
- ``construct``  discrete density evolution (regular + irregular with message
                 alignment) producing integer trellis lookup tables.
- ``decode``     decoders as pure functions: discrete IB LUT decoder,
                 belief propagation, min-sum, compiled by XLA.
- ``ops``        jnp building blocks for the hot message-passing loops.
- ``parallel``   mesh/sharding helpers (shard_map batch parallelism, psum'd
                 BER counters and syndrome checks).
- ``sim``        Monte-Carlo BER engine with SNR sweep + resumable state.
- ``models``     named end-to-end configurations (regular (3,6), WLAN 802.11n,
                 DVB-S2).
"""

__version__ = "0.1.0"
