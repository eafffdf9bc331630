"""CineForm HD (CFHD) band entropy codebook — "table 18" run/level
prefix code used by the CFHD sample bitstream (BandEncoding 3).

The codebook constants have no transcribable source in this
environment; they were recovered from the system libavcodec's
static data (the four parallel arrays adjacent to the
"vlc_18.table_size == 4572" assertion string), aligned by
prefix-code completeness (Kraft sum 1, zero collisions) and the
run/level semantic constraints, and are validated end-to-end by
decoding libavcodec cfhd encoder output in tests/test_cineform.py.

The port's copy of ``ultragrid_tpu/ops/cfhd_tables.py`` (numpy only;
copied, not imported, so the port never runs the JAX package's
``__init__``); ``tests/test_torch_cfhd_j2k.py`` holds the arrays equal.

Layout: 264 entries of (codeword value, codeword length, run,
level).  Entries with level != 0 carry a trailing sign bit on the
wire (code<<1 | negative).  Entry (run 2, level 255) is the
end-of-band escape.
"""

import base64

import numpy as np

_N = 264
_RAW = (
    "009C61O*5N00#gG3JU-X4H6Cy01y!q6aW<#9T*uG8XFuV9v=W8ApjyIB_<~*E-xx8DJ(58F)}qXG"
    "(9{wI5|2tJ3c=^K|(`BMMg(RNlQ#hO-@fxQBqS>RaRG6Sz23MU1MZkUtnQkW@Tq-XliS3ZESIFaB"
    "_3uy}ZlH#m}kVpX->wv&pQLvUuB;f75-Q_wJ+Qx7nzAfcd++h_(Obhw0vthNt+^^Vp<}o$tT<oQv"
    "{>qSd9;<Hqdjb=Q1*{{58Nl9S+%xVff;f%=zs!Laq^&XCZF@$J6wgXsLL&CGVzw0^d)jf%0E!k~G"
    "s_JYW&-NcU4$D5k;+{2;gt>Se50RRC20RRC20RRC20RRC23;+QD6aWDL0RRC2AOHaX0RRC20RRC2"
    "JOBXz0RRC20RUtG0RRC20RRC20RRC20RRC20RRC20RRC2v;YAB0RTV&0RRC20RRC20RRC20RRC20"
    "RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20R"
    "RC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RR"
    "C20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC"
    "20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC2"
    "0RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20"
    "RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20R"
    "RC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RRC20RR"
    "F30RjUB1_lQQ2L}iU2nh)Z2?`1d3JMAf3kwSi3=9km3=9kn4Gj$q4Gj$r4h{|u4-XFy4-XFz5D*X"
    "$5D^g(5fKp)5fTy-5)u*;6B82?6B82?6ciK`6ciK`6%`c~6%`c~6&4m278Vv37Z(>77Z(>87#J8B"
    "7#J8C85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF8"
    "5tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85tQF85"
    "tQF85tQF85tQF85tQF85tQF85tTH000000ssI22LJ#782|tPFaQ7mHUIzsZvX%QV*mgEX#fBKYXA"
    "TM(EtDd)Bpeg+yDRoi2(oriU9xspaB2?s{sH2cLM+b5CZ@J76SkPLjwQ+R09A2bprqZBL)Bfga!Z"
    "rg$4iss|El7>;?b;+YJB!TnqpJUJL*LL<|4`RSf_D(G36q(+vOswHp8cix>a^yBGifzZd`js2TtO"
    "pc?=Hr5gYMq#FPL6)^w+buj<{eK7z4Q#AkpXg2@=hi(7>({2C&=wbi>_+kJ6C}IErq-p>Fg>C=<Q"
    "^WuO)5QP)^ThxFq}>1j2;Bex4BY?#OS=I8O1l97rHcUo<%<CTm8t;%m#P5(q=*3k6S@HaNEZVD$Q"
    "J_uC{+UhEL8&lBy<A+G;{+1Hgp33lp+QIk}d`Sk}n1TQmO_3TB-&BYUl<4Zs-O8O6UdvDn$$cCtV"
    "BxCSMEyrc@08wp0xOme36V*3b<A-p~yIR*Dz^O}ZEWPQDlbPreucZmAjoE}<I$FQFR%ub~?Nzo8o"
    "dT|+kjeM2_@m~=4!oKiIaol-Rb-cmIH-%>RIGwEUgT`6J!J*8>@Kc#8_KBZ~^xrS~4_=au(c}mp)"
    "Wzxj}xKhLbaSh!7cuLg(a1Gr6@(tYp^9|hq_N9mc^`(db^reUa^QDLZ@}-CY@ui3X@TG_W@1=+V?"
    "xlzU?WKqTs-=hl<E4lJ-=&BFiKU1E-KB^Dc%_H|;H8KGh^2@D)}@F6+ogyB;iZTHhoy)Cnx%*V#H"
    "EM<?4^hShNXxBbESv@oTZ2X$fbw@`=y8hp{0lc>!pYRsHKPjgr$f9(xr$2nWcyUn5BpTgQbW8$)t"
    "+`(4~k0l%<FPf~AN7%cY0`*rkX8=cR}Nfu)E6>ZOPQsilYkrlp7hfTf55prwcbou!BY!=;D;f2D{"
    "4z@>-*-ld2E)TM|4ex-;3!lj4-lBI|N&83I|eWi#2qos%e=%t7OqNRude5Hs1j-`kJv!#duvZaUt"
    "v89Lsu%(Cruce3quBC_pt)++otfhzntEGqm+NFpA<fVuK<)w%L*`<g9wWWvwyrqZ%y`_i&>7|GP%"
    "%z9{g{6oA)1`<3;-!cIm8FOQmZgXRxTS~zkfn$L$)$(^q@{=f=B0=MrKN}g&ZUR}zom!)a;1m?o2"
    "7^WzNLr($EAn?%B6?_)uo65d!>j0jirbIjHQSHi=~JGilvAF$fSz_#ifV=`lW~gyQPQ$!KH`+&!v"
    "a~xuu8!wxx&xm!*gS{-uZk*QJO7x}}H#k)?<M#-)e>+@**CdZmZ~pQVTa`K5>fw55mvr=^GikEMt"
    "K{iTQjx21>ylck6Oo~4KZ_@#&e|D}il{H2Hid8LQ}_oavdqDv72qe~G3"
)

_buf = base64.b85decode("".join(_RAW))
LEVELS = np.frombuffer(_buf[:_N], np.uint8).astype(np.int32)
RUNS = np.frombuffer(_buf[_N:_N + 2 * _N], "<u2").astype(np.int32)
LENS = np.frombuffer(_buf[3 * _N:4 * _N], np.uint8).astype(np.int32)
BITS = np.frombuffer(_buf[4 * _N:4 * _N + 4 * _N], "<u4").astype(np.int64)
